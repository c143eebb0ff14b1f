"""RCB programs, RIMFS images and wire tensors cross between the JAX package
and the PyTorch port byte for byte, both ways."""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import rctc as jax_rctc
from repro.core import rimfs as jax_rimfs
from repro.core.rcb import RCBProgram as JaxProgram
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.serving import protocol as jax_proto
from repro_torch.core import rimfs
from repro_torch.core.rcb import RCBProgram
from repro_torch.core.rtpm import Platform
from repro_torch.serving import protocol as proto


def _dense_program(dtype="float32"):
    cfg = dataclasses.replace(jax_get_config("qwen2-1.5b-smoke"), dtype=dtype)
    params = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(cfg))
    return jax_rctc.compile_transformer_block(cfg, params, 2, 8)


_PROGRAMS = {
    "passthrough": lambda: jax_rctc.compile_passthrough((4, 8)),
    "matmul_dma": lambda: jax_rctc.compile_matmul(16, with_dma=True),
    "conv_relu_softmax": lambda: jax_rctc.compile_conv_relu_softmax(),
    "dense_lm_blocks": lambda: _dense_program()[0],
}


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_jax_program_bytes_decode_and_reencode_identically(name, version):
    data = _PROGRAMS[name]().encode(version=version)
    prog = RCBProgram.decode(data)
    assert prog.encode(version=version) == data
    # and the other way: the port's v2 bytes are what the JAX package emits
    assert JaxProgram.decode(prog.encode()).encode() == prog.encode()
    assert prog.crc() == JaxProgram.decode(data).crc()


def _jax_files(rng):
    return {
        "w_f32": rng.randn(16, 8).astype(np.float32),
        "w_bf16": rng.randn(5, 7).astype(ml_dtypes.bfloat16),
        "w_i8": rng.randint(-128, 127, (3, 5, 7), dtype=np.int8),
        "w_i32": rng.randint(0, 1000, (9,), dtype=np.int32),
        "scalar": np.asarray(3.5, np.float64),
    }


def test_jax_image_mounts_in_port_with_equal_bytes_bf16_included(rng):
    files = _jax_files(rng)
    image = jax_rimfs.pack(files)
    fs = rimfs.mount(image)
    theirs = jax_rimfs.mount(image)
    assert fs.files() == list(files)
    assert fs.read("w_bf16").dtype == torch.bfloat16
    for name, arr in files.items():
        got = fs.read(name)
        # both packages store a 0-d file as shape (1,)
        assert tuple(got.shape) == theirs.read(name).shape \
            == np.ascontiguousarray(arr).shape
        bits = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        assert bits.numpy().tobytes() == arr.tobytes(), name
    assert fs.fsck()["ok"]


def test_port_pack_is_byte_identical_to_jax_pack(rng):
    files = _jax_files(rng)
    theirs = jax_rimfs.pack(files)
    # the same contents handed over as torch tensors (bf16 as torch bf16)
    tensors = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
               if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v)
               for k, v in files.items()}
    assert rimfs.pack(tensors) == theirs
    assert rimfs.pack(files) == theirs              # numpy inputs too
    back = jax_rimfs.mount(rimfs.pack(tensors))
    np.testing.assert_array_equal(back.read("w_bf16"), files["w_bf16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_program_image_mounts_in_port(dtype):
    _, image = _dense_program(dtype)
    ours = rimfs.mount(image)
    theirs = jax_rimfs.mount(image)
    for name in theirs.files():
        got = ours.read(name)
        bits = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        assert bits.numpy().tobytes() == theirs.read(name).tobytes()


@pytest.mark.parametrize("where", ["program_body", "program_header",
                                   "image_data", "image_index"])
def test_flipped_byte_fails_crc_before_parse(where):
    prog, image = _dense_program()
    data = bytearray(prog.encode())
    img = bytearray(image)
    if where == "program_body":
        data[len(data) // 2] ^= 0xFF
    elif where == "program_header":
        data[20] ^= 0x01
    elif where == "image_data":
        img[-64] ^= 0xFF
    else:
        img[20] ^= 0x01
    plat = Platform(device="cpu")
    with pytest.raises(ValueError, match="CRC|magic|index|JSON|Expecting"):
        plat.provision(image=bytes(img), program_bytes=bytes(data))
    assert plat.program is None


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_wire_roundtrip(dtype, rng):
    if dtype == "bfloat16":
        value = torch.randn(3, 4, dtype=torch.float32).to(torch.bfloat16)
    else:
        value = rng.randn(3, 4).astype(dtype) if dtype == "float32" \
            else rng.randint(-9, 9, (3, 4)).astype(np.int32)
    payload = proto.pack_tensors({"x": value, "pos": np.arange(4, dtype=np.int32)})
    out = proto.unpack_tensors(payload)
    assert sorted(out) == ["pos", "x"]
    if dtype == "bfloat16":
        assert out["x"].dtype == torch.bfloat16
        assert torch.equal(out["x"].view(torch.int16), value.view(torch.int16))
    else:
        assert out["x"].dtype == value.dtype
        np.testing.assert_array_equal(out["x"], value)
        # numpy dtypes keep the JAX package's npz format exactly
        assert payload == jax_proto.pack_tensors(
            {"x": value, "pos": np.arange(4, dtype=np.int32)})
    frame = proto.encode_frame(proto.Msg.INFER_REQUEST, payload,
                               request_id=7)
    assert frame == jax_proto.encode_frame(jax_proto.Msg.INFER_REQUEST,
                                           payload, request_id=7)
    f = proto.decode_frame_ex(frame)
    assert (f.request_id, f.version, bytes(f.payload)) == (7, 2, payload)
