"""The harness end to end on the CPU at tiny cells added as new files in a
temporary copy: the cells are found by name and come out correct, and
each fault a served cell can have, planted under the timed path, makes
``correct`` false.

The fourth fault of the list, the exchange between chips left out, has no
place here: every cell runs on one card.
"""
import numpy as np
import pytest

from perfbench import harness
from repro_torch.launch.steps import CompiledDecodeStep
from repro_torch.serving.engine import EngineBase

SEED = 2**31 + 17
CELLS = ("tiny.dense", "tiny.rwkv6")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_and_is_correct(tiny_root, cell, traced):
    out = harness.run(cell, SEED, 1.5, traced, device="cpu", root=tiny_root)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    want = ({"ttft_ms.p95", "decode_step_ms.p50", "prefill_ms_per_ktok",
             "mfu", "tiny_prefills"} if traced else
            {"output_tokens_per_s", "request_latency_p50_s",
             "request_latency_p95_s", "setup_s"})
    assert set(out["metrics"]) == want
    assert out["checks"]["checked_tokens"]["value"] >= 20


def _state_unchanged(monkeypatch):
    """The decode step computes its logits but leaves its state (KV rows,
    recurrent states) as it found it."""
    call = CompiledDecodeStep.__call__

    def frozen(self, params, cache, batch):
        keep = {k: v.clone() for k, v in cache.items()}
        out = call(self, params, cache, batch)
        for k, v in cache.items():
            v.copy_(keep[k])
        return out
    monkeypatch.setattr(CompiledDecodeStep, "__call__", frozen)


def _half_batch(monkeypatch):
    """Only the first half of the lanes is computed; the other half takes
    the mean of their logits."""
    call = CompiledDecodeStep.__call__

    def half(self, params, cache, batch):
        logits, cache = call(self, params, cache, batch)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].mean(0, keepdim=True)
        return logits, cache
    monkeypatch.setattr(CompiledDecodeStep, "__call__", half)


def _token_altered(monkeypatch):
    """Every fifth sampling call moves each lane's pick to the next token
    id where it is made (so every request, and the check's sample, holds
    altered tokens)."""
    sample = EngineBase._sample
    calls = [0]

    def altered(self, logits):
        picks = sample(self, logits)
        calls[0] += 1
        if calls[0] % 5 == 0:
            picks = (picks + 1) % logits.shape[-1]
        return picks
    monkeypatch.setattr(EngineBase, "_sample", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, cell,
                                        fault):
    fault(monkeypatch)
    out = harness.run(cell, SEED, 1.5, False, device="cpu", root=tiny_root)
    assert not out["correct"]
    gap = out["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def test_a_failed_reply_is_not_correct(tiny_root, monkeypatch):
    """An engine that raises fails every request in flight: they count as
    failed, and the run is not correct."""
    from repro_torch.serving.engine import ServingEngine
    real = ServingEngine.step
    calls = [0]

    def flaky(self):
        calls[0] += 1
        if calls[0] == 40:
            raise RuntimeError("planted")
        return real(self)
    monkeypatch.setattr(ServingEngine, "step", flaky)
    out = harness.run("tiny.dense", SEED, 1.5, False, device="cpu",
                      root=tiny_root)
    assert not out["correct"]
    assert out["checks"]["failed"]["value"] > 0


def test_served_gaps_are_zero_for_the_references_own_tokens(tiny_root):
    """Tokens that are the reference's own first choices read a gap of 0."""
    from perfbench import check, reference, spec, weights
    from perfbench.record import Done
    from repro_torch.models import transformer as tf
    cell = spec.load_cell("tiny.dense", tiny_root)
    cfg = spec.port_config(cell.config)
    params = weights.draw(tf.model_specs(cfg), 5, "cpu")
    prompt = np.arange(7, dtype=np.int32)
    toks = []
    for _ in range(5):
        seq = np.concatenate([prompt, np.asarray(toks, np.int32)])
        lg = reference.logits(cell.config, params, [seq], [len(seq) - 1])[0]
        toks.append(int(lg[-1].argmax()))
    d = Done(client=0, index=0, prompt=prompt, max_new=4, t_send=0.0,
             t_reply=1.0, tokens=np.asarray(toks))
    gaps = check.served_gaps(cell.config, params, [d])
    assert float(gaps[0].max()) == 0.0
