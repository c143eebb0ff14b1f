"""Tile groups on the card: each group's stream, and the hand-offs between
them.

These tests need a CUDA device and skip without one: the CPU has no
streams, so nothing there can run out of order. On the machine with the
card:

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_partition_gpu.py

(``chip_smoke.py`` runs them.) The file imports torch and the port only, so
it runs where JAX is absent. A cut edge is redeemed on the consumer's
stream after it waits on the producer's event, so a producer slowed on
purpose still hands over its finished bytes; the redeemed buffer is marked
for the consumer's stream, so a buffer the producer drops is not rewritten
on the producer's stream while the consumer still reads it (``FREED_EDGE``
names the allocator and what the same read gives unmarked); and a
partitioned run of qwen2-1.5B's full width at 2 bf16 layers equals
``Executor.run`` bit for bit at 1, 2 and 4 groups, through the stream
schedule too and with an input the caller's stream is still writing.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import partition, rbl, rctc, rhal, rimfs
from repro_torch.core.executor import Executor
from repro_torch.core.rcb import Op
from repro_torch.kernels import registry
from repro_torch.models import transformer as tf

SPIN = 200_000_000          # cycles of torch.cuda._sleep: ~0.1 s on an H100
SEQ = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CPU has no streams")
    return torch.device("cuda")


def _bits(t):
    t = torch.as_tensor(t).cpu()
    if t.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        t = t.view(ints[t.element_size()])
    return t


def _mesh(n=2):
    mesh = rhal.TileMesh(n)
    for g in mesh.groups:               # no CRC stamp: its read-back would
        g.driver.integrity.enabled = False     # sync the producer itself
    return mesh


@pytest.mark.gpu
def test_a_slowed_producer_still_hands_over_finished_bytes(cuda):
    mesh = _mesh()
    s0, s1 = mesh.group(0).driver.stream, mesh.group(1).driver.stream
    assert s0 != s1
    x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)
    out = torch.zeros_like(x)
    torch.cuda.synchronize()
    with torch.cuda.stream(s0):
        torch.cuda._sleep(SPIN)             # the producer is slow ...
        out.copy_(x * 2)                    # ... to write its result
    ticket = mesh.stream("t", out, 0, 1)    # issued on the producer's stream
    got = mesh.group(1).driver.dma_wait(ticket)
    with torch.cuda.stream(s1):
        seen = got.clone()
    # the same read with the event dropped: the consumer runs at once
    out2 = torch.zeros_like(x)
    torch.cuda.synchronize()
    with torch.cuda.stream(s0):
        torch.cuda._sleep(SPIN)
        out2.copy_(x * 2)
    ticket2 = mesh.stream("t2", out2, 0, 1)
    ticket2.event = None
    got2 = mesh.group(1).driver.dma_wait(ticket2)
    with torch.cuda.stream(s1):
        unordered = got2.clone()
    torch.cuda.synchronize()
    assert torch.equal(seen, x * 2)
    print("STREAM_ORDER " + json.dumps({
        "ordered_read_equal": True,
        "read_without_the_event_saw_zeros": bool((unordered == 0).all())}))


@pytest.mark.gpu
def test_a_freed_cut_edge_buffer_is_not_reused_under_the_consumer(cuda):
    """The producer drops its buffer while the consumer has yet to read it,
    and a new tensor of the same size is written on the producer's
    stream: the consumer still reads the producer's bytes. (Under the
    native caching allocator the block is held back; under
    ``cudaMallocAsync`` it may come back at once, its reuse ordered after
    the consumer's read. Either way the bytes hold.) The same hand-off
    without ``record_stream`` is run for the record."""
    mesh = _mesh()
    s0, s1 = mesh.group(0).driver.stream, mesh.group(1).driver.stream
    x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)

    def hand_off(mark: bool):
        torch.cuda.synchronize()
        with torch.cuda.stream(s0):
            out = x * 3                     # allocated on the producer's
        ticket = mesh.stream("t", out, 0, 1)
        if mark:
            got = mesh.group(1).driver.dma_wait(ticket)   # marked for s1
        else:
            s1.wait_event(ticket.event)     # ordered, but not marked
            got = ticket.buf
        with torch.cuda.stream(s1):
            torch.cuda._sleep(SPIN)         # the consumer reads late
            seen = got + 0
        del out, got, ticket                # the producer lets go
        with torch.cuda.stream(s0):
            fresh = torch.empty_like(x)     # same size, producer's stream
            fresh.fill_(-1.0)
        torch.cuda.synchronize()
        return seen
    assert torch.equal(hand_off(True), x * 3)
    unmarked = hand_off(False)
    print("FREED_EDGE " + json.dumps({
        "allocator": torch.cuda.get_allocator_backend(),
        "marked_read_equal": True,
        "unmarked_read_equal": bool(torch.equal(unmarked, x * 3))}))


def _qwen2_two_layers(ex):
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2,
                              dtype="bfloat16")
    params = tf.init_params(cfg, 0)
    prog, image = rctc.compile_transformer_block(cfg, params, 1, SEQ)
    del params
    fs = rimfs.mount(image)
    bound = rbl.bind(prog, rimfs=fs, driver=ex.driver)
    rng = np.random.RandomState(1)
    req = {"hidden": torch.from_numpy(
        rng.randn(1, SEQ, cfg.d_model).astype(np.float32)).to(
            torch.bfloat16),
        "positions": np.arange(SEQ, dtype=np.int32)[None].copy()}
    return prog, fs, bound, req


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_partitioned_qwen2_equals_run_bit_for_bit(cuda, n_groups):
    ex = Executor()
    prog, fs, bound, req = _qwen2_two_layers(ex)
    want = ex.run(bound, inputs=req)["logits"]
    mesh = rhal.TileMesh(n_groups)
    counters = registry.launch_counters()
    before = counters["flash_attention"].launches
    got = ex.run_partitioned(bound, inputs=req, rimfs=fs, mesh=mesh)
    torch.cuda.synchronize()
    assert counters["flash_attention"].launches - before == 2
    assert torch.equal(_bits(got["logits"]), _bits(want))
    part = bound._partitions[n_groups]
    assert mesh.moved_bytes() == part.cut_bytes()
    assert sum(op.op is Op.ATTENTION for t in part.tiles
               for op in t.program.ops()) == 2
    # every group ran on a stream of its own, pinning only its weights
    assert len({g.driver.stream for g in mesh.groups}) == n_groups
    pinned = sum(fs._resident[id(mesh.group(t.gid).driver)][1].nbytes()
                 for t in part.tiles)
    assert pinned == fs._resident[id(ex.driver)][1].nbytes()
    # the stream schedule too: every sample in order, bit for bit
    outs = list(partition.execute_stream(part, mesh, iter([req, req]),
                                         rimfs=fs, depth=2, fused=False))
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(_bits(out["logits"]), _bits(want))
    # an input still being written on the caller's stream: the first
    # stage's stream waits for it; each stage records its timing events
    hidden = req["hidden"].to(cuda)
    late = torch.empty_like(hidden)
    torch.cuda._sleep(SPIN)
    late.copy_(hidden)
    events: list = []
    got = partition.execute(part, mesh, inputs={**req, "hidden": late},
                            rimfs=fs, stage_events=events)
    assert torch.equal(_bits(got["logits"]), _bits(want))
    assert [gid for gid, _, _ in events] == [t.gid for t in part.tiles]
    torch.cuda.synchronize()
    assert all(start.elapsed_time(end) > 0 for _, start, end in events)
