"""The port's InferenceServer on the CPU: the qwen2-1.5B smoke program
provisioned over protocol v2 and served through the plain-RCB route, with
responses bit-identical to a local run, pipelined request ids, bf16 on the
wire, BUSY on a full admission queue and a drain on SHUTDOWN."""
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.executor import Executor
from repro_torch.core.rctc import compile_transformer_block
from repro_torch.core.rtpm import Platform
from repro_torch.models import transformer as tf
from repro_torch.serving.server import Client, InferenceServer, ServerBusy

B, S = 2, 8


@functools.lru_cache(maxsize=None)
def _slice(dtype):
    cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"), dtype=dtype)
    params = tf.init_params(cfg, 0, device="cpu")
    prog, image = compile_transformer_block(cfg, params, B, S)
    glob, _ = tf.split_params(params)
    return cfg, prog.encode(), image, glob


def _request(dtype, seed):
    cfg, _, _, glob = _slice(dtype)
    tokens = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))
    return {"hidden": tf.embed_inputs(cfg, glob, tokens),
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32)[None],
                                         (B, S)).copy()}


def _local(dtype, requests):
    _, prog_bytes, image, _ = _slice(dtype)
    plat = Platform(device="cpu")
    plat.provision(image=image, program_bytes=prog_bytes)
    bound = plat.bind()
    ex = Executor(driver=plat.driver)
    return [ex.run(bound, inputs=r)["logits"] for r in requests]


def _start(dtype="float32", **kw):
    _, prog_bytes, image, _ = _slice(dtype)
    server = InferenceServer(device="cpu", **kw)
    client = Client(server.start())
    assert client.provision(image, prog_bytes) == {"status": "ready"}
    return server, client


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 \
        else torch.as_tensor(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_logits_equal_a_local_run(dtype):
    requests = [_request(dtype, 10 + i) for i in range(2)]
    server, client = _start(dtype)
    try:
        got = [client.infer(**r)["logits"] for r in requests]
        tel = client.telemetry()
    finally:
        client.close()
        server.stop()
    for g, want in zip(got, _local(dtype, requests)):
        if dtype == "bfloat16":      # bf16 crosses the wire as its bits
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
        else:
            assert isinstance(g, np.ndarray) and g.dtype == np.float32
        assert tuple(g.shape) == (B, S, _slice(dtype)[0].vocab_size)
        assert torch.equal(_bits(g), _bits(want))
    assert tel["device"] == "cpu"
    assert tel["serving"]["processed"] >= 3        # provision + 2 kicks
    assert tel["serving"]["rejected"] == 0


def test_pipelined_request_ids_come_back_right():
    requests = [_request("float32", 20 + i) for i in range(5)]
    server, client = _start()
    try:
        rids = [client.infer_async(**r) for r in requests]
        got = {}
        for j in (3, 0, 4, 1, 2):                  # scrambled collection
            got[j] = client.result(rids[j], timeout=60)["logits"]
    finally:
        client.close()
        server.stop()
    assert len(set(rids)) == len(rids)
    for j, want in enumerate(_local("float32", requests)):
        np.testing.assert_array_equal(got[j], want.numpy())


def _gate_dispatcher(server):
    """Hold the dispatcher at its next item (and keep the idle hook from
    draining around the gate); returns (gate, started)."""
    gate, started = threading.Event(), threading.Event()

    def install():
        # on the dispatcher thread, between items: no call of the old idle
        # hook is under way, so none can admit a request around the gate
        inner, idle = server._loop.handler, server._loop.on_idle

        def gated(item):
            started.set()
            gate.wait(30)
            inner(item)

        server._loop.handler = gated
        server._loop.on_idle = lambda: idle() if gate.is_set() else False

    server.run_on_dispatcher(install)
    return gate, started


def test_full_admission_queue_replies_busy():
    r = _request("float32", 30)
    server, client = _start(max_queue=1)
    try:
        gate, started = _gate_dispatcher(server)
        rid1 = client.infer_async(**r)             # admitted, kick gated
        assert started.wait(10)
        rid2 = client.infer_async(**r)             # admission queue full
        with pytest.raises(ServerBusy) as busy:
            client.result(rid2, timeout=30)
        assert busy.value.kind == "busy" and busy.value.retryable
        gate.set()
        got = client.result(rid1, timeout=60)["logits"]
        assert client.telemetry()["serving"]["rejected"] >= 1
    finally:
        client.close()
        server.stop()
    np.testing.assert_array_equal(got, _local("float32", [r])[0].numpy())


def test_shutdown_drains_queued_requests():
    requests = [_request("float32", 40 + i) for i in range(3)]
    server, client = _start()
    try:
        gate, started = _gate_dispatcher(server)
        rids = [client.infer_async(**r) for r in requests]
        assert started.wait(10)
        # the gated dispatcher holds every admitted request in the
        # scheduler: wait until the handler thread has parsed all three,
        # or the SHUTDOWN below may rightly refuse the ones not yet read
        deadline = time.monotonic() + 10
        while (server.scheduler.pending() < len(requests)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert server.scheduler.pending() == len(requests)
        acks = []
        other = Client(server.address)
        t = threading.Thread(target=lambda: acks.append(other.shutdown()))
        t.start()                                  # blocks in the drain
        deadline = time.monotonic() + 10
        while not server._stop.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        got = [client.result(rid, timeout=60)["logits"] for rid in rids]
        t.join(timeout=30)
        assert not t.is_alive() and acks == [{"status": "draining"}]
        other.close()
        deadline = time.monotonic() + 15
        while server._loop.alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not server._loop.alive()
        with pytest.raises((ServerBusy, ConnectionError, OSError)):
            client.infer(**requests[0])            # refused, never parked
    finally:
        client.close()
        server.stop()
    for g, want in zip(got, _local("float32", requests)):
        np.testing.assert_array_equal(g, want.numpy())


def test_infer_before_provision_is_an_error():
    server = InferenceServer(device="cpu")
    client = Client(server.start())
    try:
        with pytest.raises(RuntimeError, match="not provisioned"):
            client.infer(**_request("float32", 50))
    finally:
        client.close()
        server.stop()


def test_reprovision_releases_the_old_weights():
    """A second PROVISION replaces the image: the old one's arena ranges are
    released, so re-provisioning never exhausts the device arena."""
    r = _request("float32", 60)
    server, client = _start()
    try:
        first = client.infer(**r)["logits"]
        arena = server.executor.driver.arena
        in_use = arena.bytes_in_use
        _, prog_bytes, image, _ = _slice("float32")
        for _ in range(3):
            assert client.provision(image, prog_bytes) == {"status": "ready"}
            assert arena.bytes_in_use == in_use
        np.testing.assert_array_equal(client.infer(**r)["logits"], first)
    finally:
        client.close()
        server.stop()


def test_both_ends_of_a_connection_send_without_nagle_delay():
    """A frame goes out as head, payload parts and a 4-byte CRC trailer;
    with Nagle's algorithm the trailer waits for the peer's delayed ACK
    (tens of ms a request on a warm connection), so every connection the
    server accepts and every client opens sets TCP_NODELAY."""
    import socket
    accepted = []
    server = InferenceServer(device="cpu")
    handle = server._handle

    def recording(conn):
        accepted.append(conn.getsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY))
        handle(conn)

    server._handle = recording
    client = Client(server.start())
    try:
        with pytest.raises(RuntimeError, match="not provisioned"):
            client.infer(hidden=np.zeros((1, 1), np.float32))
        assert client.sock.getsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY)
        assert accepted and all(accepted)
    finally:
        client.close()
        server.stop()
