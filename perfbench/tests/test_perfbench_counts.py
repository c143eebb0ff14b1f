"""The yardstick's counts against values worked out by hand at tiny
shapes."""
import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench import counts


def test_causal_pairs_equal_the_loop():
    for s, sk in ((1, 1), (5, 5), (7, 3), (3, 7), (64, 64)):
        assert counts.causal_pairs(s, sk) == sum(min(i + 1, sk)
                                                 for i in range(s))


def test_attention_bound_by_hand():
    # b1 s4 sk4 h2 hkv1 d8 bf16: bytes (2*4*2*8 + 2*4*1*8) * 2 = 384;
    # pairs 10, ops 4 * 8 * 10 * 2 = 640
    ms, by = counts.attention_bound(1, 4, 4, 2, 1, 8, "bfloat16", True)
    assert by == "bytes"
    assert ms == pytest.approx(384 / 3.35e12 * 1e3)
    ms, by = counts.attention_bound(1, 4096, 4096, 32, 8, 128, "bfloat16",
                                    True)
    assert by == "operations"
    assert ms == pytest.approx(4 * 128 * (4096 * 4097 // 2) * 32 / 989e12
                               * 1e3)


def test_wkv6_bound_by_hand():
    ms, by, nbytes, ops = counts.wkv6_bound(1, 3, 2, 4, "float32")
    assert nbytes == 5 * 3 * 2 * 4 * 4 + 2 * 4 * 4
    assert ops == 5 * 3 * 2 * 16 + 4 * 3 * 2 * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


DENSE = {"reference": "dense", "num_hidden_layers": 2, "hidden_size": 8,
         "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
         "intermediate_size": 16, "vocab_size": 10}
RWKV = {"reference": "rwkv6", "num_hidden_layers": 2, "hidden_size": 8,
        "head_size": 4, "intermediate_size": 16, "vocab_size": 10}


def test_dense_prefill_and_decode_flops_by_hand():
    # a token through a layer: q 8x8, k and v 8x4 each, o 8x8, MLP 3 x 8x16
    per_tok = 64 + 32 + 32 + 64 + 3 * 128                       # 576
    s = 3
    attn = 4 * 4 * 2 * 6                                        # pairs 6
    assert counts.prefill_flops(DENSE, s) == 2 * (2 * s * per_tok + attn) \
        + 2 * 8 * 10
    # lanes at positions 2 and 5 attend 3 and 6 rows
    attn = 4 * 4 * 2 * 9
    assert counts.decode_flops(DENSE, [2, 5]) == 2 * (2 * 2 * per_tok + attn) \
        + 2 * 2 * 8 * 10


def test_rwkv_prefill_and_decode_flops_by_hand():
    per_tok = 5 * 64 + 2 * 8 * 64 + 2 * 8 * 16 + 64             # 1664
    wkv = 5 * 3 * 2 * 16 + 4 * 3 * 2 * 4                        # t=3, H=2, K=4
    assert counts.prefill_flops(RWKV, 3) == 2 * (2 * 3 * per_tok + wkv) \
        + 2 * 8 * 10
    wkv1 = 5 * 2 * 16 + 4 * 2 * 4
    assert counts.decode_flops(RWKV, [7, 9, 11]) == 3 * (
        2 * (2 * per_tok + wkv1) + 2 * 8 * 10)


def test_decode_bytes_bound_by_hand():
    cfg = types.SimpleNamespace(d_model=8)
    params = {"embed": torch.zeros(10, 8, dtype=torch.bfloat16),
              "final_norm": torch.zeros(8, dtype=torch.bfloat16),
              "w": torch.zeros(4, 4, dtype=torch.bfloat16)}
    cache = {"k": torch.zeros(2, 3, 16, 1, 4, dtype=torch.bfloat16)}
    b = counts.decode_bytes_bound(cfg, params, cache, [1, 4])
    weights = 16 + 32
    kv = 2 * (2 * 1 * 4 * 2) * (5 + 2)
    assert b["weights_bytes"] == weights and b["kv_bytes"] == kv
    assert b["bytes"] == weights + 8 * 2 * 2 + kv


def test_a_new_family_counts_from_a_file_of_its_own(tiny_root):
    """A reference module added as a file is found by the configuration
    file's ``reference`` name; an unknown name fails to import."""
    (tiny_root / "perfbench/reference/toy.py").write_text(
        "def prefill_flops(config, s):\n    return 7 * s\n\n\n"
        "def decode_flops(config, positions):\n"
        "    return 3 * len(positions)\n")
    code = ("from perfbench import counts; c = {'reference': 'toy'}; "
            "print(counts.prefill_flops(c, 5), counts.decode_flops(c, [1, 2]))")
    env = {**os.environ, "PYTHONPATH": str(tiny_root)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny_root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["35", "6"]
    with pytest.raises(ModuleNotFoundError):
        counts.prefill_flops({"reference": "no_such_family"}, 1)
