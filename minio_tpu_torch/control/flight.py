"""Flight recorder: SLO-triggered, cluster-correlated diagnostic capture.

The diagnostic surfaces this repo already has (trace hub, stage ledger,
profiler windows, ops/s ring, degrade counters) all answer "what is
happening NOW"; a p99 spike or error storm at production QPS is over
before an operator can attach /trace. This module is the black box: it
holds the recent past in bounded memory and, when an SLO trigger fires,
freezes one timestamped bundle per node -- the SAME wall-clock window on
every node, so an incident reads as one correlated fleet-wide dump instead
of N skewed snapshots. The reference ships post-hoc support bundles
(`mc admin inspect`, healthinfo); this is the trigger-driven counterpart.

Three pieces:
  * SpanRing -- bounded ring of recently finished ROOT spans, fed by
    PerfSys.on_span_finish PRE-SAMPLING: MTPU_TRACE_SAMPLE thins hub/slow
    publication, never the black box. Appends are a single deque.append on
    a maxlen deque -- O(1), atomic under the GIL, no lock on the hot path.
  * FlightRecorder -- bundle assembly (span slice + windowed ops/s series +
    ledger/degrade/profiler/pool snapshots) over an on-disk store with a
    per-node retention cap; capture runs on the trigger thread or an admin
    executor thread, never the request path.
  * The trigger engine -- the "flight-trigger" daemon thread polls the
    OpsTimeSeries once per second plus the degrade counters, and fires on:
    error-rate spike, per-second p99 over threshold, a requests-shed or
    breaker-open edge, or a deadline-abort burst. One shared cooldown keeps
    a sustained incident from machine-gunning bundles.

On trigger, the incident (id + wall-clock window) fans out through
dist/peer.py (`flightcapture` verb) so every peer captures the identical
window; a node receiving the fanout arms its own cooldown, so the cluster
produces one bundle set per incident no matter how many nodes noticed.

Knobs (env, re-read on every ensure_started so scenario-declared env wins):
MTPU_FLIGHT=0 disarms the trigger thread (the ring stays on);
MTPU_FLIGHT_DIR (bundle directory, default a per-pid tempdir);
MTPU_FLIGHT_RING (root spans retained, default 512);
MTPU_FLIGHT_WINDOW_S (capture window, default 30);
MTPU_FLIGHT_COOLDOWN_S (trigger refractory period, default 60);
MTPU_FLIGHT_RETAIN (bundles kept on disk per node, default 16);
MTPU_FLIGHT_POLL_S (trigger poll cadence, default 1.0);
MTPU_FLIGHT_ERR_RATE (per-second error fraction threshold, default 0.5);
MTPU_FLIGHT_P99_MS (per-second p99 threshold, default 0 = off);
MTPU_FLIGHT_MIN_OPS (per-second op floor for rate/p99 triggers, default 10);
MTPU_FLIGHT_DEADLINE_BURST (aborts per poll that count as a burst, default 3).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import tempfile
import threading
import time
from collections import deque

from .degrade import GLOBAL_DEGRADE
from .perf import (
    GLOBAL_PERF,
    N_BUCKETS,
    _env_float,
    _env_int,
    quantile,
    summarize,
    summarize_timeseries,
)
from .sanitizer import san_lock

BUNDLE_SCHEMA = 1

# Every reason a bundle can carry (tools/flight_check.py validates against
# this set; "manual" is the POST /flight/dump path).
TRIGGER_KINDS = (
    "error-spike", "p99", "shed", "breaker-open", "deadline-burst", "manual",
)


def _safe_tag(node: str) -> str:
    """Filesystem-safe node tag: URLs become dash-words, '' becomes local."""
    return re.sub(r"[^A-Za-z0-9._-]+", "-", node).strip("-") or "local"


class SpanRing:
    """Bounded, PRE-SAMPLING ring of recently finished root spans.

    PerfSys.on_span_finish appends every ROOT span here whether or not the
    trace was sampled for hub publication -- the black box must see the
    request that blew the SLO even when MTPU_TRACE_SAMPLE thinned the live
    stream. The append is one deque.append on a maxlen deque: O(1), no
    lock, eviction implicit (oldest falls off)."""

    def __init__(self, maxlen: int | None = None):
        self.maxlen = max(
            16, maxlen if maxlen is not None else _env_int("MTPU_FLIGHT_RING", 512)
        )
        self._ring: deque = deque(maxlen=self.maxlen)

    def append(self, rec: dict) -> None:
        self._ring.append(rec)

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def window(self, t0: float, t1: float) -> list[dict]:
        """Ring entries whose finish time falls in [t0, t1] (a list() of a
        deque is safe against concurrent appends)."""
        return [r for r in list(self._ring) if t0 <= r["t"] <= t1]


class FlightRecorder:
    """Always-on black box + trigger engine + on-disk bundle store.

    One per process (GLOBAL_FLIGHT), like GLOBAL_PERF/GLOBAL_PROFILER: the
    in-process test cluster shares it, which is why capture() takes a node
    tag -- the peer `flightcapture` verb files each node's bundle under its
    own identity even when every node lives in one process."""

    def __init__(
        self,
        dir: str | None = None,
        ring: int | None = None,
        window_s: float | None = None,
        cooldown_s: float | None = None,
        retain: int | None = None,
        poll_s: float | None = None,
        err_rate: float | None = None,
        p99_ms: float | None = None,
        min_ops: int | None = None,
        deadline_burst: int | None = None,
        perf=None,
        degrade=None,
    ):
        # Constructor args pin a knob forever (tests); None falls back to
        # the env var, re-read on every ensure_started() so a scenario's
        # declared env (tools/loadgen.py sets it pre-build) takes effect.
        self._overrides = {
            "dir": dir, "window_s": window_s, "cooldown_s": cooldown_s,
            "retain": retain, "poll_s": poll_s, "err_rate": err_rate,
            "p99_ms": p99_ms, "min_ops": min_ops,
            "deadline_burst": deadline_burst,
        }
        self.perf = perf if perf is not None else GLOBAL_PERF
        self.degrade = degrade if degrade is not None else GLOBAL_DEGRADE
        self.ring = SpanRing(ring)
        self._lock = san_lock("FlightRecorder._lock")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._seq = itertools.count(1)
        self._last_trigger_t = 0.0
        self._last_sec_checked = 0
        self._deg_prev: dict | None = None
        self._deg_history: deque = deque(maxlen=120)
        self.node_id = "local"
        self.fanout = None  # callable(incident) wired by dist/node.py build()
        self.pool_status_fn = None  # callable() -> dict, wired the same way
        # Counters (control/metrics.py _render_flight exports these; the
        # mtpulint metrics-rendered scope includes this file).
        self.triggers: dict[str, int] = {}  # reason -> incidents opened
        self.bundles_written = 0
        self.bundles_pruned = 0
        self.suppressed = 0  # trigger evaluations muted by the cooldown
        self.capture_errors = 0
        self.fanout_errors = 0
        self.configure()

    def configure(self) -> None:
        """(Re)resolve every knob: constructor override wins, else env."""
        ov = self._overrides
        self.dir = ov["dir"] or os.environ.get("MTPU_FLIGHT_DIR", "") or (
            os.path.join(tempfile.gettempdir(), f"mtpu-flight-{os.getpid()}")
        )
        self.window_s = ov["window_s"] if ov["window_s"] is not None else (
            _env_float("MTPU_FLIGHT_WINDOW_S", 30.0)
        )
        self.cooldown_s = ov["cooldown_s"] if ov["cooldown_s"] is not None else (
            _env_float("MTPU_FLIGHT_COOLDOWN_S", 60.0)
        )
        self.retain = max(
            1, ov["retain"] if ov["retain"] is not None
            else _env_int("MTPU_FLIGHT_RETAIN", 16)
        )
        self.poll_s = max(
            0.05, ov["poll_s"] if ov["poll_s"] is not None
            else _env_float("MTPU_FLIGHT_POLL_S", 1.0)
        )
        self.err_rate = ov["err_rate"] if ov["err_rate"] is not None else (
            _env_float("MTPU_FLIGHT_ERR_RATE", 0.5)
        )
        self.p99_ms = ov["p99_ms"] if ov["p99_ms"] is not None else (
            _env_float("MTPU_FLIGHT_P99_MS", 0.0)
        )
        self.min_ops = ov["min_ops"] if ov["min_ops"] is not None else (
            _env_int("MTPU_FLIGHT_MIN_OPS", 10)
        )
        self.deadline_burst = max(
            1, ov["deadline_burst"] if ov["deadline_burst"] is not None
            else _env_int("MTPU_FLIGHT_DEADLINE_BURST", 3)
        )

    # -- node wiring (dist/node.py build) ------------------------------------

    def register_node(self, url: str, fanout=None, pool_status_fn=None) -> None:
        """Late binding: the recorder exists at import, nodes come later.
        Last registration wins -- one node per process in production; the
        in-process test cluster's peers capture under their own tags via
        the `flightcapture` peer verb regardless."""
        self.node_id = url
        if fanout is not None:
            self.fanout = fanout
        if pool_status_fn is not None:
            self.pool_status_fn = pool_status_fn

    def unregister_node(self, url: str, fanout) -> bool:
        """Undo register_node() for a closing node, if its registration is
        still the live one (a later node's stays). Returns whether it was."""
        with self._lock:
            if self.node_id != url or self.fanout != fanout:
                return False
            self.node_id = "local"
            self.fanout = None
            self.pool_status_fn = None
            return True

    # -- black box (hot path) -------------------------------------------------

    def record_span(self, span, duration_s: float, error: str | None = None) -> None:
        """PerfSys.on_span_finish feeds every finished ROOT span here,
        before (and regardless of) the MTPU_TRACE_SAMPLE verdict. One dict
        build + one lock-free deque append."""
        rec = {
            "t": time.time(),
            "name": span.name,
            "layer": span.layer,
            "trace": span.trace_id,
            "duration_ms": round(duration_s * 1e3, 3),
        }
        if error:
            rec["error"] = error
        self.ring.append(rec)

    # -- trigger math (injectable clock) ---------------------------------------

    def check_triggers(self, now: float | None = None) -> list[tuple[str, dict]]:
        """Evaluate every trigger kind; returns [(reason, detail), ...].

        Rate/p99 triggers judge the last CLOSED second of the ops/s ring
        (the current second is still filling) and each second is judged
        once. Edge triggers difference the degrade counters against the
        previous poll -- the first poll only establishes the baseline.
        """
        now = time.time() if now is None else now
        fired: list[tuple[str, dict]] = []
        t = int(now) - 1
        if t > self._last_sec_checked:
            self._last_sec_checked = t
            snap = self.perf.timeseries.snapshot(now=now)
            sec = next((e for e in snap["series"] if e["t"] == t), None)
            if sec is not None:
                count = sum(c["count"] for c in sec["classes"].values())
                errs = sum(c["errors"] for c in sec["classes"].values())
                if count >= self.min_ops and errs / count >= self.err_rate:
                    fired.append(("error-spike", {
                        "second": t, "count": count, "errors": errs,
                        "rate": round(errs / count, 4),
                    }))
                if self.p99_ms > 0 and count >= self.min_ops:
                    counts = [0] * (N_BUCKETS + 1)
                    for c in sec["classes"].values():
                        counts = [a + b for a, b in zip(counts, c["counts"])]
                    p99 = quantile(counts, 0.99) * 1e3
                    if p99 >= self.p99_ms:
                        fired.append(("p99", {
                            "second": t, "count": count,
                            "p99_ms": round(p99, 3),
                        }))
        deg = self.degrade.snapshot()
        cur = {
            "sheds": sum(deg["sheds"].values()),
            "breaker_trips": deg["breaker_trips"],
            "deadline_aborts": sum(deg["deadline_aborts"].values()),
        }
        prev = self._deg_prev
        self._deg_prev = cur
        self._deg_history.append({"t": now, **cur})
        if prev is not None:
            if cur["sheds"] > prev["sheds"]:
                fired.append(("shed", {"sheds": cur["sheds"] - prev["sheds"]}))
            if cur["breaker_trips"] > prev["breaker_trips"]:
                fired.append(("breaker-open", {
                    "trips": cur["breaker_trips"] - prev["breaker_trips"],
                }))
            if cur["deadline_aborts"] - prev["deadline_aborts"] >= self.deadline_burst:
                fired.append(("deadline-burst", {
                    "aborts": cur["deadline_aborts"] - prev["deadline_aborts"],
                }))
        return fired

    def poll_once(self, now: float | None = None):
        """One trigger-engine tick: evaluate, honor the cooldown, fire at
        most ONE incident (co-fired reasons ride along in the detail)."""
        now = time.time() if now is None else now
        fired = self.check_triggers(now)
        if not fired:
            return None
        if now - self._last_trigger_t < self.cooldown_s:
            with self._lock:
                self.suppressed += 1
            return None
        reason, detail = fired[0]
        if len(fired) > 1:
            detail = dict(detail, also=[r for r, _ in fired[1:]])
        return self.trigger(reason, detail=detail, now=now)

    # -- incident capture -------------------------------------------------------

    def trigger(self, reason: str, detail: dict | None = None,
                now: float | None = None, fan_out: bool = True) -> dict:
        """Open an incident: capture this node's bundle, then broadcast the
        SAME wall-clock window to every peer. Runs on the trigger thread or
        an admin executor thread -- never the request path."""
        now = time.time() if now is None else now
        self._last_trigger_t = now
        seq = next(self._seq)
        with self._lock:
            self.triggers[reason] = self.triggers.get(reason, 0) + 1
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        incident = {
            "incident": f"{stamp}-{reason}-{seq}",
            "reason": reason,
            "detail": detail or {},
            "t0": now - self.window_s,
            "t1": now,
            "origin": self.node_id,
        }
        self.capture(incident)
        fan = self.fanout
        if fan_out and fan is not None:
            try:
                fan(incident)
            except Exception:  # noqa: BLE001 - a dead peer must not kill the trigger thread
                with self._lock:
                    self.fanout_errors += 1
        return incident

    def capture(self, incident: dict, node: str | None = None) -> str | None:
        """Write ONE node's bundle for an incident; idempotent per
        (incident, node) so a replayed fanout is a no-op. Receiving a
        capture also arms the cooldown -- this node's own trigger must not
        re-open the same incident seconds later."""
        iid = str(incident.get("incident", "") or "")
        if not iid:
            return None
        node = node or self.node_id
        safe = _safe_tag(node)
        path = os.path.join(self.dir, f"flight-{iid}__{safe}.json")
        if os.path.exists(path):
            return None
        self._last_trigger_t = max(
            self._last_trigger_t, float(incident.get("t1", 0.0))
        )
        try:
            bundle = self.build_bundle(incident, node)
            os.makedirs(self.dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f)
            os.replace(tmp, path)
            with self._lock:
                self.bundles_written += 1
        except Exception:  # noqa: BLE001 - diagnostics must never take down serving
            with self._lock:
                self.capture_errors += 1
            return None
        self._prune(safe)
        return bundle["id"]

    def build_bundle(self, incident: dict, node: str) -> dict:
        """Everything an incident needs in one JSON document: the span slice
        and ops/s seconds INSIDE the window, plus point-in-time snapshots of
        the cumulative planes (ledger, degrade, profiler, pools)."""
        t0 = float(incident.get("t0", 0.0))
        t1 = float(incident.get("t1", 0.0))
        # snapshot(now=t1): ring slots within window_s of the incident end;
        # using the wall clock here would blind injected-clock tests.
        ts = self.perf.timeseries.snapshot(now=t1)
        series = [e for e in ts["series"] if t0 - 1 <= e["t"] <= t1]
        bundle = {
            "flight_bundle": BUNDLE_SCHEMA,
            "id": f"{incident['incident']}__{_safe_tag(node)}",
            "incident": incident["incident"],
            "node": node,
            "reason": str(incident.get("reason", "manual")),
            "detail": incident.get("detail", {}) or {},
            "origin": str(incident.get("origin", "")),
            "window": {"t0": t0, "t1": t1},
            "captured_at": time.time(),
            "spans": self.ring.window(t0, t1),
            "timeseries": summarize_timeseries({**ts, "series": series}),
            "ledger": summarize(self.perf.ledger.snapshot()),
            "degrade": self.degrade.snapshot(),
            "degrade_history": [
                h for h in list(self._deg_history) if t0 <= h["t"] <= t1
            ],
        }
        try:
            from .profiler import GLOBAL_PROFILER

            bundle["profiler"] = GLOBAL_PROFILER.summary()
        except Exception as e:  # noqa: BLE001 - a bundle missing one plane still ships
            bundle["profiler"] = {"error": type(e).__name__}
        psf = self.pool_status_fn
        if psf is not None:
            try:
                bundle["pools"] = psf()
            except Exception as e:  # noqa: BLE001
                bundle["pools"] = {"error": type(e).__name__}
        return bundle

    def _prune(self, safe_node: str) -> None:
        """On-disk retention cap: keep the newest MTPU_FLIGHT_RETAIN bundles
        PER NODE TAG (the shared in-process store holds one set per node)."""
        try:
            names = [
                n for n in os.listdir(self.dir)
                if n.startswith("flight-") and n.endswith(f"__{safe_node}.json")
            ]
        except OSError:
            return
        if len(names) <= self.retain:
            return
        def mtime(n: str) -> tuple:
            try:
                return (os.path.getmtime(os.path.join(self.dir, n)), n)
            except OSError:
                return (0.0, n)
        names.sort(key=mtime)
        for n in names[: len(names) - self.retain]:
            try:
                os.remove(os.path.join(self.dir, n))
                with self._lock:
                    self.bundles_pruned += 1
            except OSError:
                pass  # a concurrent prune won the race; the cap still holds

    # -- store reads ------------------------------------------------------------

    def _read(self, path: str) -> dict | None:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def list(self) -> list[dict]:
        """Bundle metas on disk, newest first (GET /flight)."""
        try:
            names = [
                n for n in os.listdir(self.dir)
                if n.startswith("flight-") and n.endswith(".json")
            ]
        except OSError:
            return []
        out = []
        for n in names:
            b = self._read(os.path.join(self.dir, n))
            if not b or b.get("flight_bundle") != BUNDLE_SCHEMA:
                continue
            out.append({
                k: b.get(k)
                for k in ("id", "incident", "node", "reason", "origin",
                          "window", "captured_at")
            })
        out.sort(key=lambda m: (m.get("captured_at") or 0, m.get("id") or ""),
                 reverse=True)
        return out

    def get(self, bundle_id: str) -> dict | None:
        """Fetch one full bundle by exact id, or the newest bundle of an
        incident when given a bare incident id (GET /flight/{id})."""
        if not bundle_id:
            return None
        exact = os.path.join(self.dir, f"flight-{bundle_id}.json")
        b = self._read(exact)
        if b is not None:
            return b
        match = None
        for meta in self.list():  # newest first
            if meta.get("incident") == bundle_id or meta.get("id") == bundle_id:
                match = self._read(
                    os.path.join(self.dir, f"flight-{meta['id']}.json")
                )
                if match is not None:
                    return match
        return match

    # -- lifecycle ---------------------------------------------------------------

    def ensure_started(self) -> bool:
        """Arm the trigger engine (idempotent). MTPU_FLIGHT=0 vetoes --
        tests default it off (tests/conftest.py) and opt in explicitly."""
        if os.environ.get("MTPU_FLIGHT", "") == "0":
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return True
            self.configure()
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="flight-trigger", daemon=True
            )
            self._thread.start()
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the watchdog must outlive one bad snapshot
                with self._lock:
                    self.capture_errors += 1

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5)

    def reset(self) -> None:
        """Drop the ring, the cooldown, and the trigger baselines -- NOT the
        cumulative counters (rate signals) and NOT the on-disk bundles
        (retention owns those). Loadgen runs call this pre-phases so stale
        state can't satisfy (or pollute) a flight gate."""
        self.ring.clear()
        self._last_trigger_t = 0.0
        self._last_sec_checked = 0
        self._deg_prev = None
        self._deg_history.clear()

    def stats(self) -> dict:
        """Counter snapshot for /flight and the minio_tpu_flight_* series."""
        with self._lock:
            return {
                "armed": self._thread is not None and self._thread.is_alive(),
                "dir": self.dir,
                "ring_spans": len(self.ring),
                "ring_max": self.ring.maxlen,
                "triggers": dict(self.triggers),
                "bundles_written": self.bundles_written,
                "bundles_pruned": self.bundles_pruned,
                "suppressed": self.suppressed,
                "capture_errors": self.capture_errors,
                "fanout_errors": self.fanout_errors,
                "last_trigger_time": self._last_trigger_t,
            }


GLOBAL_FLIGHT = FlightRecorder()
# Install the pre-sampling root-span feed: perf.py cannot import this module
# (flight reads the ledger/timeseries), so PerfSys carries a late-bound hook.
GLOBAL_PERF.flight = GLOBAL_FLIGHT
