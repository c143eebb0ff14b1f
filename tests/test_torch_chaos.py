"""The chaos schedules on the port, at CPU size (the JAX package's
tests/chaos.py scenarios through ``repro_torch.serving.chaos``): sustained
paced traffic over a ``TileMesh`` while the coordinator scales, kills,
journals through faults, corrupts DMA payloads, swaps good and bad weights,
hangs a redemption (``run_chaos``), or runs a good and a bad canary, slows
a group and bursts low-priority traffic into the brown-out ladder
(``run_rollout_chaos``). Each scenario must end with zero failed client
requests and zero mismatched replies, and must finish inside its own time
limit of 60 s (it runs on a thread the test joins with that timeout)."""
import threading

from repro_torch.serving import chaos

LIMIT_S = 60.0


def _within_limit(fn, **kw) -> dict:
    box: dict = {}

    def run():
        try:
            box["report"] = fn(**kw)
        except BaseException as e:          # re-raised on the test thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    assert not t.is_alive(), f"{fn.__name__} ran past {LIMIT_S} s"
    if "error" in box:
        raise box["error"]
    return box["report"]


def test_run_chaos_converges_on_the_port():
    report = _within_limit(chaos.run_chaos, groups=2, seed=5, requests=60,
                           clients=3, scale_peak=8, pace_s=0.01,
                           dma_delay_s=0.1, watchdog_floor=0.5,
                           device="cpu")
    assert chaos.check_report(report) == []
    assert report["failed"] == 0 and report["mismatches"] == 0
    assert report["ok"] == report["sent"] == 60
    assert report["journal"] == {"rolled_back": 2, "replayed": 1,
                                 "image_ok": True}
    assert report["dma_crc"]["dma_retry_recovered"] == 3
    assert report["watchdog"]["released"]
    assert report["n_groups_final"] == 2


def test_run_rollout_chaos_converges_on_the_port():
    report = _within_limit(chaos.run_rollout_chaos, groups=2, seed=5,
                           requests=60, clients=3, pace_s=0.01, burst=36,
                           device="cpu")
    assert chaos.check_rollout_report(report) == []
    assert report["failed"] == 0 and report["mismatches"] == 0
    assert report["ok"] == report["sent"] == 60
    assert report["canary_bad_stats"]["served_shadow"] == 0
    assert report["reshape"]["survivors_untouched"]
