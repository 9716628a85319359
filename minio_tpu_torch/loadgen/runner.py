"""Scenario execution: drive a target with the generated op sequence and
measure every op into the control/perf.py bucket scheme.

Timing discipline:
  * op generation is pre-run (generators.py) -- the replay clock never
    waits on the dice;
  * prepopulation happens OFF the clock -- a scenario measures steady
    state, not its own setup;
  * each phase owns a fresh StageLedger keyed ("loadgen", op kind), so
    per-phase tails never bleed into each other, and the phase snapshots
    merge (control/perf.py merge_snapshots) into the run-wide view.

Chaos windows arm real faults through the admin surface at their declared
offsets (threading.Timer off the worker path) and ALWAYS disarm on exit --
a loadgen crash must not leave a live cluster injecting faults.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..control.perf import StageLedger
from .generators import Op, generate_ops, op_sequence_hash
from .spec import Phase, Scenario
from .target import OpResult, S3Target
from ..control.sanitizer import san_lock, san_rlock

# Op-list cap for duration-bounded phases (generated up front; the run
# consumes a prefix). Logged into the phase result when it truncates.
_DURATION_OP_CAP = 200_000


def _payload(key: str, size: int) -> bytes:
    """Deterministic CSV-shaped payload: SELECT ops over these objects
    exercise the real scan path instead of erroring on binary junk."""
    if size <= 0:
        return b""
    row = f"{key},0123456789abcdef,42\n".encode()
    reps = size // len(row) + 1
    return (row * reps)[:size]


@dataclass
class PhaseResult:
    name: str
    concurrency: int
    wall_s: float = 0.0
    executed: int = 0
    generated: int = 0
    truncated: bool = False  # duration phase hit the op-list cap
    op_hash: str = ""
    ledger: StageLedger = field(default_factory=StageLedger)
    # kind -> {"ok": n, "bytes": n, "errors": {class: n}}
    kinds: dict = field(default_factory=dict)
    # second offset -> {"ops": n, "errors": n}
    timeline: dict = field(default_factory=dict)
    chaos_windows: list = field(default_factory=list)
    # memcache counter DELTA over this phase ({} when the tier is off):
    # run-cumulative counters can't judge one phase's hit ratio.
    cache: dict = field(default_factory=dict)


_CACHE_COUNTERS = (
    "hits", "misses", "fills", "evictions", "invalidations",
    "singleflight_waits",
)


def _cache_delta(before: dict, after: dict) -> dict:
    if not after:
        return {}
    out = {k: after.get(k, 0) - before.get(k, 0) for k in _CACHE_COUNTERS}
    out["bytes"] = after.get("bytes", 0)
    out["entries"] = after.get("entries", 0)
    lookups = out["hits"] + out["misses"]
    out["hit_ratio"] = round(out["hits"] / lookups, 4) if lookups else 0.0
    return out


class ScenarioRunner:
    def __init__(self, scenario: Scenario, target: S3Target, admin, log=None):
        self.scenario = scenario
        self.target = target
        self.admin = admin  # InProcessAdmin | EndpointAdmin
        self._log = log or (lambda msg: None)

    # -- op dispatch -------------------------------------------------------

    def _execute(self, op: Op) -> OpResult:
        b = self.scenario.bucket
        node = op.index  # S3Target mods by len(urls): round-robin
        if op.kind == "GET":
            return self.target.get(b, op.key, node=node)
        if op.kind == "PUT":
            return self.target.put(b, op.key, _payload(op.key, op.size), node=node)
        if op.kind == "DELETE":
            return self.target.delete(b, op.key, node=node)
        if op.kind == "LIST":
            return self.target.list(b, op.prefix, self.scenario.list_max_keys, node=node)
        if op.kind == "MULTIPART":
            part = _payload(op.key, self.scenario.multipart_part_size)
            return self.target.multipart(
                b, op.key, part, self.scenario.multipart_parts, node=node
            )
        if op.kind == "SELECT":
            return self.target.select(b, op.key, node=node)
        return OpResult(False, "unknown-op", 0)

    # -- setup -------------------------------------------------------------

    def prepopulate(self) -> int:
        """PUT the declared base keyspace (off the measurement clock)."""
        sc = self.scenario
        self.target.ensure_bucket(sc.bucket)
        if not sc.prepopulate:
            return 0
        import random

        from .generators import SizeDistribution

        rng = random.Random(sc.seed ^ 0x5EED)
        sizes = SizeDistribution(sc.sizes)
        keys = [
            (f"{sc.prefix}key-{kid:06d}", sizes.sample(rng))
            for kid in range(min(sc.prepopulate, sc.keys))
        ]
        failures = 0
        with ThreadPoolExecutor(max_workers=8, thread_name_prefix="lg-prepop") as ex:
            futs = [
                ex.submit(self.target.put, sc.bucket, k, _payload(k, n), i)
                for i, (k, n) in enumerate(keys)
            ]
            for f in futs:
                if not f.result().ok:
                    failures += 1
        if failures:
            raise RuntimeError(f"prepopulate: {failures}/{len(keys)} PUTs failed")
        return len(keys)

    # -- phase execution ---------------------------------------------------

    def _run_phase(self, phase: Phase) -> PhaseResult:
        count = phase.ops or _DURATION_OP_CAP
        ops = generate_ops(self.scenario, phase, count)
        pr = PhaseResult(
            name=phase.name,
            concurrency=phase.concurrency,
            generated=len(ops),
            truncated=not phase.ops,
            op_hash=op_sequence_hash(ops),
        )
        try:
            cache_before = self.admin.cache_stats()
        except Exception:  # noqa: BLE001 - a live target may deny admin
            cache_before = {}
        stats_lock = san_lock("ScenarioRunner.stats_lock")
        next_idx = itertools.count()
        stop = threading.Event()
        start = time.monotonic()
        deadline = start + phase.duration_s if phase.duration_s else None

        def worker(wi: int) -> None:
            if phase.ramp_s and phase.concurrency > 1:
                delay = phase.ramp_s * wi / phase.concurrency
                if stop.wait(delay):
                    return
            while not stop.is_set():
                i = next(next_idx)
                if i >= len(ops):
                    return
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    return
                op = ops[i]
                t0 = time.perf_counter()
                c0 = time.thread_time()
                res = self._execute(op)
                dt = time.perf_counter() - t0
                pr.ledger.record("loadgen", op.kind, dt, time.thread_time() - c0)
                sec = int(time.monotonic() - start)
                with stats_lock:
                    pr.executed += 1
                    row = pr.kinds.setdefault(
                        op.kind, {"ok": 0, "bytes": 0, "errors": {}}
                    )
                    tl = pr.timeline.setdefault(sec, {"ops": 0, "errors": 0})
                    tl["ops"] += 1
                    if res.ok:
                        row["ok"] += 1
                        row["bytes"] += res.nbytes
                    else:
                        row["errors"][res.error_class] = (
                            row["errors"].get(res.error_class, 0) + 1
                        )
                        tl["errors"] += 1

        timers: list[threading.Timer] = []
        armed: dict[str, dict] = {}
        armed_lock = san_lock("ScenarioRunner.armed_lock")

        def arm(window_i: int, fault: dict, at_s: float, for_s: float) -> None:
            try:
                fid = self.admin.arm_fault(fault)
            except Exception as e:  # noqa: BLE001 - report, don't kill workers
                pr.chaos_windows.append(
                    {"at_s": at_s, "for_s": for_s, "fault": fault,
                     "error": f"{type(e).__name__}: {e}"[:200]}
                )
                return
            rec = {
                "at_s": at_s, "for_s": for_s, "fault": fault, "fault_id": fid,
                "armed_at_s": round(time.monotonic() - start, 3),
            }
            with armed_lock:
                armed[fid] = rec
            pr.chaos_windows.append(rec)
            t = threading.Timer(for_s, disarm, args=(fid,))
            t.daemon = True
            timers.append(t)
            t.start()

        def disarm(fid: str) -> None:
            with armed_lock:
                rec = armed.pop(fid, None)
            if rec is None:
                return
            try:
                self.admin.disarm_fault(fid)
                rec["disarmed_at_s"] = round(time.monotonic() - start, 3)
            except Exception as e:  # noqa: BLE001
                rec["error"] = f"disarm: {type(e).__name__}: {e}"[:200]

        def run_admin(admin_op: dict, at_s: float) -> None:
            # One-shot admin window (pool attach / decommission /
            # rebalance): fired once, never disarmed -- a drain keeps
            # running after the window by design.
            rec = {"at_s": at_s, "admin": admin_op}
            try:
                rec["result"] = self.admin.pool_admin(admin_op)
                rec["ran_at_s"] = round(time.monotonic() - start, 3)
            except Exception as e:  # noqa: BLE001 - report, don't kill workers
                rec["error"] = f"{type(e).__name__}: {e}"[:200]
            with armed_lock:
                pr.chaos_windows.append(rec)

        for wi_c, cw in enumerate(phase.chaos):
            if cw.admin is not None:
                t = threading.Timer(cw.at_s, run_admin, args=(cw.admin, cw.at_s))
            else:
                t = threading.Timer(
                    cw.at_s, arm, args=(wi_c, cw.fault, cw.at_s, cw.for_s)
                )
            t.daemon = True
            timers.append(t)
            t.start()

        threads = [
            threading.Thread(target=worker, args=(wi,), name=f"lg-{phase.name}-{wi}")
            for wi in range(phase.concurrency)
        ]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            stop.set()
            for t in timers:
                t.cancel()
            for fid in list(armed):
                disarm(fid)
        pr.wall_s = time.monotonic() - start
        try:
            pr.cache = _cache_delta(cache_before, self.admin.cache_stats())
        except Exception:  # noqa: BLE001
            pr.cache = {}
        return pr

    # -- whole run ---------------------------------------------------------

    def run(self) -> dict:
        from .report import build_report

        sc = self.scenario
        if sc.profile:
            # Arm the continuous profiling plane before the clock starts so
            # the run's windows cover the measured phases.
            try:
                armed = self.admin.start_profile()
                self._log(f"profiling plane {'armed' if armed else 'UNAVAILABLE'}")
            except Exception:  # noqa: BLE001 - a live target may deny admin
                pass
        self._log(f"prepopulating {sc.prepopulate} objects into {sc.bucket!r}")
        self.prepopulate()
        # A clean measurement window: setup traffic must not pollute the
        # cluster stage breakdown the report attributes the run to.
        try:
            self.admin.reset_perf()
        except Exception:  # noqa: BLE001 - a live target may deny admin
            pass
        if sc.flight is not None:
            # Clear the recorder's cooldown/baselines so a trigger from a
            # previous run in this process can't mute the fault window.
            try:
                self.admin.flight_reset()
            except Exception:  # noqa: BLE001 - a live target may deny admin
                pass
        run_t0 = time.time()
        # Wall-clock phase windows: the flight gate correlates bundle
        # windows (wall clock, cluster-wide) against the faulted phase.
        phase_windows: dict[str, tuple[float, float]] = {}
        results: list[PhaseResult] = []
        for phase in sc.phases:
            self._log(
                f"phase {phase.name!r}: concurrency={phase.concurrency} "
                + (f"ops={phase.ops}" if phase.ops else f"duration={phase.duration_s}s")
            )
            w0 = time.time()
            results.append(self._run_phase(phase))
            phase_windows[phase.name] = (w0, time.time())
        try:
            stage_breakdown = self.admin.stage_breakdown()
        except Exception:  # noqa: BLE001
            stage_breakdown = {}
        try:
            degrade = self.admin.degrade()
        except Exception:  # noqa: BLE001
            degrade = {}
        try:
            cache = self.admin.cache_stats()
        except Exception:  # noqa: BLE001
            cache = {}
        profile = None
        if sc.profile:
            try:
                profile = self.admin.profile_summary() or None
            except Exception:  # noqa: BLE001
                profile = None
        pools_report = None
        if sc.pools_gate is not None:
            pools_report = self._await_drained(sc.pools_gate)
        flight_report = None
        if sc.flight is not None:
            flight_report = self._await_flight(sc.flight, phase_windows, run_t0)
        from ..control.sanitizer import profile_if_armed

        report = build_report(
            sc,
            results,
            stage_breakdown=stage_breakdown,
            degrade=degrade,
            probe_cached=bool(getattr(self.admin, "probe_cached", False)),
            lock_profile=profile_if_armed(),
            profile=profile,
            cache=cache,
        )
        if pools_report is not None:
            report["pools"] = pools_report
        if flight_report is not None:
            report["flight"] = flight_report
        return report

    def _await_flight(self, gate: dict, windows: dict, run_t0: float) -> dict:
        """Post-run flight gate: the faulted phase must have auto-captured a
        diagnostic bundle on EVERY node whose window covers the fault, and no
        bundle may have triggered outside it (a false alarm in a healthy
        phase is as much a bug as a missed incident). Waits off the
        measurement clock -- the trigger engine judges a second only after it
        closes, so the fault phase's bundle can land just after it ends."""
        phase = str(gate.get("phase", ""))
        max_s = float(gate.get("max_wait_s", 15.0))
        w0, w1 = windows.get(phase, (run_t0, run_t0))
        grace = 3.0  # closed-second judging + poll cadence + fanout
        expected = len(getattr(self.target, "urls", None) or []) or self.scenario.nodes
        t_start = time.monotonic()
        captured: list = []
        false_triggers: list = []
        nodes: set = set()
        while True:
            try:
                metas = self.admin.flight_bundles()
            except Exception:  # noqa: BLE001 - a live target may deny admin
                metas = []
            captured, false_triggers, nodes = [], [], set()
            for m in metas:
                win = m.get("window") or {}
                t1 = float(win.get("t1", 0.0))
                if t1 < run_t0:
                    continue  # stale bundle from an earlier run
                if w0 - 1.0 <= t1 <= w1 + grace:
                    captured.append(m)
                    nodes.add(m.get("node", ""))
                else:
                    false_triggers.append(m)
            if len(nodes) >= expected or time.monotonic() - t_start >= max_s:
                break
            time.sleep(0.25)
        ok = len(nodes) >= expected and not false_triggers
        out = {
            "phase": phase,
            "window": [w0, w1],
            "expected_nodes": expected,
            "nodes_captured": sorted(nodes),
            "bundles": captured,
            "false_triggers": false_triggers,
            "ok": ok,
        }
        if ok:
            self._log(
                f"flight gate: {len(captured)} bundle(s) across "
                f"{len(nodes)}/{expected} nodes for phase {phase!r}"
            )
        else:
            self._log(
                f"flight gate FAILED: {len(nodes)}/{expected} nodes captured, "
                f"{len(false_triggers)} false trigger(s)"
            )
        return out

    def _await_drained(self, gate: dict) -> dict:
        """Post-run pool gate: poll the pool-lifecycle status until every
        pool in require_drained reports 'decommissioned' (or max_drain_s
        runs out). The drain keeps working after the traffic stops, so the
        wait happens off the measurement clock."""
        require = list(gate.get("require_drained") or [])
        max_s = float(gate.get("max_drain_s", 120.0))
        t0 = time.monotonic()
        status: dict = {}
        drained = not require
        while not drained and time.monotonic() - t0 < max_s:
            try:
                status = self.admin.pool_status()
            except Exception:  # noqa: BLE001 - a live target may deny admin
                status = {}
            rows = {r.get("index"): r for r in status.get("pools", [])}
            drained = all(
                rows.get(pi, {}).get("status") == "decommissioned"
                for pi in require
            )
            if not drained:
                time.sleep(0.25)
        out = {
            "require_drained": require,
            "max_drain_s": max_s,
            "drained": drained,
            "ok": drained,
            "status": status,
        }
        if drained and require:
            out["time_to_drained_s"] = round(time.monotonic() - t0, 3)
            self._log(f"pools {require} drained in {out['time_to_drained_s']}s")
        elif require:
            self._log(f"pools {require} NOT drained within {max_s}s")
        return out
