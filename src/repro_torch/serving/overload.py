"""Brown-out overload control plane.

The port's counterpart of ``repro.serving.overload``. Under sustained
overload a serving fleet has two honest moves: do less work per request, or
refuse some requests with a typed verdict. ``BrownoutController`` walks a
ladder of degradation rungs DOWN under pressure and back UP with hysteresis
once the pressure clears; every transition is one dispatcher control op
(atomic between requests), every shed is machine-readable, every move an
RTPM event:

  rung 0  normal            full service
  rung 1  narrow_batch      coalescing window -> 1 (no request waits for
                            company)
  rung 2  clamp_decode      LM admissions get their max_new clamped
  rung 3  shed_low_prio     priority classes >= ``shed_priority`` are shed
                            at admission with verdict kind "brownout"
                            (retryable: capacity WILL return)
  rung 4  circuit_break     the worst *failing* tile group is circuit-
                            broken: killed (partition failover routes
                            around it), probed with golden inputs after a
                            cooldown (half-open), revived and CRC-checked
                            only when the probe answers bit-identically

The controller watches the dispatcher's queue-wait p99 and the admission
miss rate over WINDOWED telemetry (only the samples since its previous
tick), needs ``escalate_ticks`` consecutive hot ticks to descend a rung and
``recover_ticks`` consecutive cool ticks (with a margin) to climb one back.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

from repro_torch.core import fleet as fleet_mod


@dataclasses.dataclass
class OverloadConfig:
    """Brown-out policy knobs (hysteresis lives here, not in code)."""
    p99_high: float = 0.5          # queue-wait p99 (s) that reads as hot
    miss_rate_high: float = 0.20   # shed fraction that reads as hot
    min_window: int = 4            # min new samples before judging a tick
    escalate_ticks: int = 2        # consecutive hot ticks -> down a rung
    recover_ticks: int = 3         # consecutive cool ticks -> up a rung
    recover_margin: float = 0.5    # cool = p99 < margin * p99_high
    max_new_clamp: int = 8         # rung 2: LM decode budget per request
    shed_priority: int = 2         # rung 3: shed priority classes >= this
    breaker_cooldown_ticks: int = 3   # circuit open -> half-open probe
    breaker_min_failures: int = 1  # tile failures before a group is a
                                   # circuit-break candidate
    control_timeout: float = 60.0
    probe_seed: int = 0xF1EE7      # golden-input seed (the fleet's)


#: (rung, name, what degrades) — the ladder, worst rung last.
RUNGS = (
    (0, "normal", "full service"),
    (1, "narrow_batch", "batch coalescing window -> 1"),
    (2, "clamp_decode", "LM max_new clamped"),
    (3, "shed_low_priority", "low-priority admissions shed (brownout)"),
    (4, "circuit_break", "failing tile group circuit-broken"),
)
MAX_RUNG = RUNGS[-1][0]


class CircuitBreaker:
    """Open / half-open / closed over ONE tile group.

    ``trip`` kills the group through the quarantine path (the partition
    failover already routes around dead groups, so no request is dropped).
    After ``breaker_cooldown_ticks`` the breaker goes half-open: golden
    inputs run through the full serving path twice, once while the group is
    still excluded (the survivors' answer) and once after it is revived
    (its resident weights CRC-checked against the image on its stream). A
    bit-identical answer closes the circuit; anything else re-kills the
    group and restarts the cooldown."""

    def __init__(self, server, cfg: OverloadConfig):
        self.server = server
        self.cfg = cfg
        self.state = "closed"
        self.gid: Optional[int] = None
        self._cooldown = 0
        self.stats = {"trips": 0, "probes": 0, "closes": 0}

    def trip(self, gid: int) -> bool:
        server = self.server
        mesh = server.mesh
        if self.state != "closed" or mesh is None or not mesh.alive(gid):
            return False

        def isolate():
            mesh.kill(gid)
            return True

        server.run_on_dispatcher(isolate, timeout=self.cfg.control_timeout)
        self.state = "open"
        self.gid = gid
        self._cooldown = self.cfg.breaker_cooldown_ticks
        self.stats["trips"] += 1
        server.platform.post("circuit_open", {"group": gid})
        return True

    def tick(self) -> None:
        if self.state != "open":
            return
        self._cooldown -= 1
        if self._cooldown <= 0:
            self.probe()

    def probe(self) -> bool:
        """Half-open: revive and golden-probe the quarantined group."""
        server, gid = self.server, self.gid
        mesh = server.mesh
        if mesh is None or gid is None:
            self.state = "closed"
            return True
        self.state = "half_open"
        self.stats["probes"] += 1
        golden = fleet_mod.golden_inputs(server.platform.program,
                                         seed=self.cfg.probe_seed)
        timeout = self.cfg.control_timeout
        try:
            # reference answer from the SURVIVORS (gid still excluded)
            ref = server.run_on_dispatcher(lambda: server._infer(golden),
                                           timeout=timeout)

            def revive():
                mesh.revive(gid, server.platform.rimfs)
                return True

            server.run_on_dispatcher(revive, timeout=timeout)
            probe = server.run_on_dispatcher(lambda: server._infer(golden),
                                             timeout=timeout)
            ok = fleet_mod.same_outputs(probe, ref)
        except Exception:
            ok = False
        if ok:
            self.state = "closed"
            self.gid = None
            self.stats["closes"] += 1
            server.platform.post("circuit_closed", {"group": gid})
            # the revived group answered correctly; its name is live again
            server.platform.heartbeats.beat(f"tile{gid}", 0)
            return True
        # probe failed: back to quarantine, fresh cooldown
        if mesh.alive(gid):
            def isolate():
                mesh.kill(gid)
                return True
            try:
                server.run_on_dispatcher(isolate, timeout=timeout)
            except Exception:
                pass
        self.state = "open"
        self._cooldown = self.cfg.breaker_cooldown_ticks
        server.platform.post("circuit_open",
                             {"group": gid, "reason": "probe failed"})
        return False


class BrownoutController:
    """Observe -> decide -> degrade/recover, one rung per decision.

    Owns NO request-path state: every service-level change rides
    ``run_on_dispatcher`` so it lands between requests. Stepped by hand
    (``tick``) for deterministic tests or run on a background thread
    (``start``/``stop``)."""

    EVENTS = ("brownout_rung", "brownout_shed", "circuit_open",
              "circuit_closed")

    def __init__(self, server, config: Optional[OverloadConfig] = None):
        self.server = server
        self.cfg = config or OverloadConfig()
        self.rung = 0
        self.events: list = []
        self.history: list = []
        self.breaker = CircuitBreaker(server, self.cfg)
        self._hot_streak = 0
        self._cool_streak = 0
        self._saved_window = server.batch_window
        self._wait_seen = server._loop.queue_wait.count()
        self._last = {"shed": self._shed_total(),
                      "served": self._served_total()}
        self._shed_mark = self._shed_total()   # brownout_shed accounting
        self._fail_counts: dict = {}           # gid -> tile failures seen
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stopev = threading.Event()
        for kind in self.EVENTS:
            server.platform.events.register(
                kind, (lambda k: lambda p: self.events.append((k, p)))(kind))
        server.platform.events.register("tile_failure", self._on_failure)
        server.platform.events.register("watchdog_preempt", self._on_failure)

    def _on_failure(self, payload: dict) -> None:
        gid = payload.get("group")
        if gid is not None:
            self._fail_counts[gid] = self._fail_counts.get(gid, 0) + 1

    # ----------------------------------------------------------- telemetry
    def _shed_total(self) -> int:
        s = self.server.scheduler.shed_count
        eng = self.server.engine
        if eng is not None and eng.scheduler is not None:
            s += eng.scheduler.shed_count
        return s

    def _served_total(self) -> int:
        return self.server.platform.telemetry.count()

    def observe(self) -> dict:
        """Windowed pressure signals: queue-wait p99 over ONLY the
        dispatches since the previous tick, the miss rate over the same
        interval, and the current backlog depth."""
        loop = self.server._loop
        qw = loop.queue_wait
        n = qw.count()
        win = qw.summary(warmup=self._wait_seen)
        self._wait_seen = n
        shed, served = self._shed_total(), self._served_total()
        shed_d = shed - self._last["shed"]
        served_d = served - self._last["served"]
        self._last = {"shed": shed, "served": served}
        depth = loop.depth() + self.server.scheduler.pending()
        return {"p99": win.get("p99"), "window": win.get("n", 0),
                "shed_delta": shed_d, "served_delta": served_d,
                "miss_rate": shed_d / max(1, shed_d + served_d),
                "depth": depth}

    # -------------------------------------------------------------- policy
    def decide(self, obs: dict) -> int:
        """-1 (recover a rung), 0 (hold), +1 (degrade a rung)."""
        cfg = self.cfg
        p99 = obs["p99"]
        hot = (p99 is not None and obs["window"] >= cfg.min_window
               and p99 > cfg.p99_high) or \
            (obs["shed_delta"] + obs["served_delta"] >= cfg.min_window
             and obs["miss_rate"] > cfg.miss_rate_high)
        cool = (p99 is None or p99 < cfg.recover_margin * cfg.p99_high) \
            and obs["miss_rate"] <= cfg.miss_rate_high / 2 \
            and obs["depth"] <= 1
        if hot:
            self._hot_streak += 1
            self._cool_streak = 0
        elif cool:
            self._cool_streak += 1
            self._hot_streak = 0
        else:
            self._hot_streak = self._cool_streak = 0
        if self._hot_streak >= cfg.escalate_ticks and self.rung < MAX_RUNG:
            self._hot_streak = 0
            return 1
        if self._cool_streak >= cfg.recover_ticks and self.rung > 0:
            self._cool_streak = 0
            return -1
        return 0

    def tick(self) -> dict:
        with self._lock:
            obs = self.observe()
            self.breaker.tick()
            delta = self.decide(obs)
            report = {"obs": obs, "rung": self.rung, "delta": delta,
                      "breaker": self.breaker.state}
            if delta:
                self.set_rung(self.rung + delta,
                              reason="pressure" if delta > 0 else "recovery")
                report["rung"] = self.rung
            # honest accounting: admissions shed while the ladder is
            # engaged surface as brownout_shed telemetry
            if self.rung >= 3:
                shed_now = self._shed_total()
                d = shed_now - self._shed_mark
                if d > 0:
                    self.server.platform.post("brownout_shed", {"n": d})
            self._shed_mark = self._shed_total()
            self.history.append(report)
            return report

    # ------------------------------------------------------------- actions
    def _worst_failing_group(self) -> Optional[int]:
        mesh = self.server.mesh
        if mesh is None:
            return None
        cands = {g: n for g, n in self._fail_counts.items()
                 if n >= self.cfg.breaker_min_failures
                 and 0 <= g < mesh.n_groups and mesh.alive(g)}
        return max(cands, key=cands.get) if cands else None

    def set_rung(self, target: int, reason: str = "manual") -> dict:
        """Apply every service-level change for ``target`` as ONE dispatcher
        control op: the ladder state a request observes is always one
        rung, never a half-applied mix."""
        with self._lock:
            cfg = self.cfg
            target = max(0, min(MAX_RUNG, int(target)))
            prev = self.rung
            server = self.server

            def apply():
                server.batch_window = 1 if target >= 1 \
                    else self._saved_window
                server.max_new_clamp = cfg.max_new_clamp \
                    if target >= 2 else None
                ceiling = cfg.shed_priority if target >= 3 else None
                server.scheduler.priority_ceiling = ceiling
                eng = server.engine
                if eng is not None and eng.scheduler is not None:
                    eng.scheduler.priority_ceiling = ceiling
                return True

            server.run_on_dispatcher(apply,
                                     timeout=cfg.control_timeout)
            tripped = None
            if target >= 4 and self.breaker.state == "closed":
                gid = self._worst_failing_group()
                if gid is not None and self.breaker.trip(gid):
                    tripped = gid
                    self._fail_counts.pop(gid, None)
            self.rung = target
            report = {"from": prev, "to": target, "reason": reason,
                      "name": RUNGS[target][1], "tripped": tripped}
            if target != prev:
                server.platform.post("brownout_rung", report)
            return report

    # ----------------------------------------------------------- lifecycle
    def start(self, interval: float = 0.1) -> None:
        if self._thread is not None:
            raise RuntimeError("brown-out controller already running")
        self._stopev.clear()

        def loop():
            while not self._stopev.wait(interval):
                try:
                    self.tick()
                except Exception:
                    pass          # a bad tick must not kill the loop

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="brownout-controller")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stopev.set()
        self._thread.join(timeout=10)
        self._thread = None

    def summary(self) -> dict:
        kinds = collections.Counter(k for k, _ in self.events)
        return {"rung": self.rung, "name": RUNGS[self.rung][1],
                "ticks": len(self.history), "events": dict(kinds),
                "breaker": {"state": self.breaker.state,
                            "gid": self.breaker.gid,
                            **self.breaker.stats}}
