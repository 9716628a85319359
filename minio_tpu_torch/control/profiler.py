"""Continuous profiling plane: role-aggregated stacks, GIL load, copy ledger.

cProfile installs a per-thread tracing hook: enabled inside a request
handler it observes only that one executor thread, so a server profile
comes back empty. Sampling ``sys._current_frames()`` from a dedicated
thread sees EVERY thread (event loop, executor workers, erasure I/O,
batching codec, scanner) -- the role of the reference's pprof CPU profile
(cmd/admin-handlers.go:511-716), with py-spy-style output.

This module carries both profiling surfaces:

  * SamplingProfiler -- the on-demand start/stop sampler behind the admin
    ``/profile/start`` + ``/profile/stop`` broadcast (kept for operator
    deep dives: per-thread stacks at 5 ms).
  * ContinuousProfiler / GilLoadProbe / CopyLedger / ProfilerSys -- the
    always-on plane: rotating fixed windows of collapsed stacks aggregated
    by thread ROLE, a calibrated GIL-load probe, and per-hop byte-copy
    accounting on the PUT/GET data path. Served by
    ``GET /mtpu/admin/v1/profile`` and embedded in loadgen/bench reports.

The three axes answer the questions the stage ledger (control/perf.py)
cannot: WHERE threads spend their samples (stacks by role), whether wall
time is GIL wait or real work (gil_load + the ledger's cpu_seconds
column), and how many times each byte is copied on its way through the
data path (the scorecard for the zero-copy pipeline work).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter, deque

from .sanitizer import san_lock

# -- thread roles -------------------------------------------------------------

# Thread-name prefix -> role. The sanitizer work standardized these names
# (every pool/daemon in the tree is created with an explicit name); the
# continuous profiler aggregates samples by role so a profile window reads
# as "62% api-executor, 21% codec-batch, ..." instead of 64 anonymous
# drive-io workers each owning 1%. First match wins; unknown names fall
# into "other" (a growing "other" share means a pool was renamed without
# updating this table).
ROLE_PREFIXES: tuple[tuple[str, str], ...] = (
    ("asyncio_", "api-executor"),        # asyncio.to_thread pool: handler bodies
    ("http-server", "api-loop"),         # aiohttp event-loop thread
    ("lg-", "loadgen"),                  # loadgen workers + prepop pool
    ("drive-io", "drive-io"),            # object/metadata.py fan-out pool
    ("encode-batch", "codec-batch"),     # parallel/batching.py workers
    ("codec-", "codec-batch"),           # codec-warmup / codec-probe
    ("etag-md5", "hash"),                # object/erasure.py pipelined MD5
    ("put-stager", "stager"),            # PUT readahead (object/erasure.py)
    ("get-stager", "stager"),            # GET readahead (object/erasure.py)
    ("peer-stream-pump", "rpc"),
    ("hub-bridge", "rpc"),
    ("lock-refresh", "rpc"),
    ("repl-", "rpc"),
    ("data-scanner", "scanner"),
    ("mrf-heal", "scanner"),
    ("heal-", "scanner"),
    ("disk-heal-monitor", "scanner"),
    ("breaker-probe", "scanner"),
    ("prof-", "profiler"),
    ("gil-probe", "profiler"),
    ("flight-trigger", "profiler"),      # flight-recorder SLO watcher
    ("log-webhook", "rpc"),              # webhook log/audit sender
    ("MainThread", "main"),
)


def thread_role(name: str) -> str:
    """Map a thread name onto its data-plane role (see ROLE_PREFIXES)."""
    for prefix, role in ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    return "other"


def _collapse(frame, depth: int = 48) -> str:
    """One thread's stack as a flamegraph collapsed-stack fragment:
    ``file:func;file:func`` outermost-first, depth-capped."""
    parts: list[str] = []
    f = frame
    d = 0
    while f is not None and d < depth:
        code = f.f_code
        parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
        f = f.f_back
        d += 1
    parts.reverse()
    return ";".join(parts)


# -- on-demand sampler (admin /profile/start + /profile/stop) ------------------


class SamplingProfiler:
    """Start/stop sampler; report() returns a text summary."""

    def __init__(self, interval_s: float = 0.005, max_duration_s: float = 900.0):
        self.interval_s = interval_s
        # Safety valve: an orchestration failure (peer stop call lost) must
        # not leave a sampler walking every thread's frames forever.
        self.max_duration_s = max_duration_s
        # report() may be called while the sampler thread is still
        # aggregating (admin peeks mid-profile): mutating a Counter during
        # most_common() is a RuntimeError, so both sides take this lock.
        self._data_lock = san_lock("SamplingProfiler._data_lock")
        self._stacks: Counter[str] = Counter()
        self._samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0
        self._elapsed = 0.0

    @property
    def elapsed_s(self) -> float:
        """Sampling time so far. Tracked monotonically by the sampler
        thread itself: live while running, frozen at the moment sampling
        actually ended (stop() or the max_duration_s safety valve) -- a
        stop() that arrives hours after the valve fired must not inflate
        the denominator every percentage in report() is computed against."""
        return self._elapsed

    def start(self) -> None:
        if self._thread is not None:
            raise ValueError("profiler already running")
        self._stop.clear()
        self._t0 = time.monotonic()
        self._elapsed = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True, name="prof-sampler")
        self._thread.start()

    def _run(self) -> None:
        me = threading.get_ident()
        names = {}
        try:
            while not self._stop.is_set():
                self._elapsed = time.monotonic() - self._t0
                if self._elapsed > self.max_duration_s:
                    break
                names.clear()
                for t in threading.enumerate():
                    names[t.ident] = t.name
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = _collapse(frame)
                    with self._data_lock:
                        self._stacks[f"[{names.get(tid, tid)}] {stack}"] += 1
                with self._data_lock:
                    self._samples += 1
                self._stop.wait(self.interval_s)
        finally:
            # Freeze elapsed at the instant sampling ends, whichever exit
            # path was taken (stop() event or the safety valve).
            self._elapsed = time.monotonic() - self._t0

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None

    def report(self, top: int = 60) -> str:
        with self._data_lock:
            samples = self._samples
            common = self._stacks.most_common(top)
        lines = [
            f"sampling profile: {samples} samples over "
            f"{self._elapsed:.1f}s (interval {self.interval_s * 1000:.0f} ms), "
            "cumulative per-thread collapsed stacks",
            "",
        ]
        for stack, n in common:
            pct = 100.0 * n / max(1, samples)
            lines.append(f"{n:7d} {pct:5.1f}%  {stack}")
        return "\n".join(lines) + "\n"


# -- continuous role-aggregated stack windows ----------------------------------

# Distinct collapsed stacks kept per window. Past the cap new stacks are
# counted (dropped_stacks) instead of stored: a pathological workload bounds
# profiler memory, it does not grow it.
_WINDOW_STACK_CAP = 4096


class _Window:
    __slots__ = (
        "start_wall", "start_mono", "end_mono",
        "samples", "stacks", "roles", "overhead_s", "dropped_stacks",
    )

    def __init__(self, now_wall: float, now_mono: float):
        self.start_wall = now_wall
        self.start_mono = now_mono
        self.end_mono = 0.0           # 0 while the window is still filling
        self.samples = 0
        self.stacks: Counter[str] = Counter()  # "role;file:fn;..." -> samples
        self.roles: Counter[str] = Counter()   # role -> samples
        self.overhead_s = 0.0         # sampler self-time spent in this window
        self.dropped_stacks = 0

    def to_dict(self, now_mono: float, top: int = 0) -> dict:
        dur = (self.end_mono or now_mono) - self.start_mono
        stacks = self.stacks.most_common(top) if top else sorted(self.stacks.items())
        return {
            "start_time": round(self.start_wall, 3),
            "duration_s": round(dur, 3),
            "closed": bool(self.end_mono),
            "samples": self.samples,
            "overhead_s": round(self.overhead_s, 6),
            "overhead_ratio": round(self.overhead_s / dur, 6) if dur > 0 else 0.0,
            "roles": dict(self.roles),
            "stacks": {k: n for k, n in stacks},
            "dropped_stacks": self.dropped_stacks,
        }


class ContinuousProfiler:
    """Always-on sampler: rotating fixed windows of role-keyed stacks.

    Lower duty cycle than SamplingProfiler (10 ms default interval vs
    5 ms) because it never stops; the cost of each tick is self-measured
    into the live window (overhead_s / overhead_ratio) so "low overhead"
    is a reported number, not a claim."""

    def __init__(self, interval_s: float = 0.010, window_s: float = 60.0,
                 max_windows: int = 5):
        self.interval_s = interval_s
        self.window_s = window_s
        self._lock = san_lock("ContinuousProfiler._lock")
        self._ring: deque[_Window] = deque(maxlen=max_windows)  # closed windows
        self._cur: _Window | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.windows_rotated = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="prof-continuous"
        )
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5)
        self._thread = None
        with self._lock:
            if self._cur is not None:
                self._cur.end_mono = time.monotonic()
                self._ring.append(self._cur)
                self._cur = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- sampling loop -----------------------------------------------------

    def _rotate_locked(self, now_mono: float) -> int:
        """Close the live window into the ring and open a fresh one; the
        caller holds _lock and adds the return value to windows_rotated
        there (keeps the read-modify-write lexically under the lock)."""
        closed = 0
        if self._cur is not None:
            self._cur.end_mono = now_mono
            self._ring.append(self._cur)
            closed = 1
        self._cur = _Window(time.time(), now_mono)
        return closed

    def _run(self) -> None:
        me = threading.get_ident()
        with self._lock:
            self.windows_rotated += self._rotate_locked(time.monotonic())
        while not self._stop.is_set():
            t0 = time.perf_counter()
            now = time.monotonic()
            roles = {
                t.ident: thread_role(t.name)
                for t in threading.enumerate()
                if t.ident is not None
            }
            sampled: list[tuple[str, str]] = []
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                sampled.append((roles.get(tid, "other"), _collapse(frame)))
            cost = time.perf_counter() - t0
            with self._lock:
                win = self._cur
                if win is None or now - win.start_mono >= self.window_s:
                    self.windows_rotated += self._rotate_locked(now)
                    win = self._cur
                win.samples += 1
                win.overhead_s += cost
                for role, stack in sampled:
                    win.roles[role] += 1
                    key = f"{role};{stack}"
                    if key in win.stacks or len(win.stacks) < _WINDOW_STACK_CAP:
                        win.stacks[key] += 1
                    else:
                        win.dropped_stacks += 1
            self._stop.wait(self.interval_s)

    # -- read side ---------------------------------------------------------

    def windows(self, top: int = 0, include_current: bool = True) -> list[dict]:
        """Serializable windows, oldest first; the live window last."""
        now = time.monotonic()
        with self._lock:
            out = [w.to_dict(now, top=top) for w in self._ring]
            if include_current and self._cur is not None and self._cur.samples:
                out.append(self._cur.to_dict(now, top=top))
        return out

    def overhead_ratio(self) -> float:
        """Sampler self-time as a fraction of wall time, over everything
        currently retained -- the "is it really low-overhead" gauge."""
        now = time.monotonic()
        wall = cost = 0.0
        with self._lock:
            wins = list(self._ring) + ([self._cur] if self._cur else [])
        for w in wins:
            wall += (w.end_mono or now) - w.start_mono
            cost += w.overhead_s
        return cost / wall if wall > 0 else 0.0

    def collapsed(self, top: int = 0) -> str:
        """All retained windows merged, in flamegraph collapsed-stack
        format (``role;file:func;... count`` lines) -- feed straight into
        flamegraph.pl / speedscope / tools/profile_diff.py."""
        merged: Counter[str] = Counter()
        for w in self.windows(top=0):
            merged.update(w["stacks"])
        items = merged.most_common(top) if top else sorted(merged.items())
        return "\n".join(f"{k} {n}" for k, n in items) + ("\n" if items else "")


# -- GIL load probe ------------------------------------------------------------


class GilLoadProbe:
    """Scheduling-jitter GIL-load estimate from a dedicated thread.

    gil_load's approach, without ctypes: a thread that only ever sleeps
    measures how late each wake-up is. A sleeping thread that wakes must
    re-acquire the GIL; under contention that wait approaches the switch
    interval (sys.getswitchinterval(), default 5 ms) times the runnable
    thread count. load = mean wake-up excess over the calibrated floor,
    normalized by the switch interval and clamped to [0, 1]: ~0 on an idle
    interpreter, ->1 when CPU-bound threads hold the GIL continuously.

    Calibration: the first _CALIB_TICKS delays establish the floor (timer
    slop + scheduler latency that exists even with a free GIL), so the
    reported load measures GIL pressure, not OS jitter."""

    _CALIB_TICKS = 8

    def __init__(self, interval_s: float = 0.02, ring: int = 64):
        self.interval_s = interval_s
        self._lock = san_lock("GilLoadProbe._lock")
        self._delays: deque[float] = deque(maxlen=ring)
        self._floor: float | None = None
        self._calib: list[float] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="gil-probe")
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            if self._stop.wait(self.interval_s):
                break
            delay = max(0.0, time.perf_counter() - t0 - self.interval_s)
            with self._lock:
                self.ticks += 1
                if self._floor is None:
                    self._calib.append(delay)
                    if len(self._calib) >= self._CALIB_TICKS:
                        self._floor = min(self._calib)
                        self._calib.clear()
                else:
                    self._delays.append(delay)

    def value(self) -> float:
        """Current GIL-load estimate in [0, 1]; 0.0 until calibrated."""
        with self._lock:
            floor = self._floor
            delays = list(self._delays)
        if floor is None or not delays:
            return 0.0
        excess = sum(max(0.0, d - floor) for d in delays) / len(delays)
        switch = max(sys.getswitchinterval(), 1e-4)
        return min(1.0, excess / switch)


# -- copy ledger ---------------------------------------------------------------

# kind labels for CopyLedger.record: "copied" = the hop materialized a new
# buffer holding the bytes (bytes(), bytearray slicing, join, fresh read
# buffers); "moved" = the hop passed the SAME buffer along (references,
# memoryviews, writes straight from the caller's buffer).
COPIED = "copied"
MOVED = "moved"


class CopyLedger:
    """Per-hop bytes-copied vs bytes-moved accounting on the data path.

    Hot-path cost is one lock + two dict bumps per record; callers batch at
    the chunk level (one record per read()/write(), not per byte). The four
    public maps are keyed by hop name and rendered by control/metrics.py as
    minio_tpu_copy_bytes_total{hop,kind} / minio_tpu_copy_ops_total
    (mtpulint's metrics-rendered rule holds this module to that)."""

    def __init__(self):
        self._lock = san_lock("CopyLedger._lock")
        self.copied_bytes: dict[str, int] = {}
        self.copied_ops: dict[str, int] = {}
        self.moved_bytes: dict[str, int] = {}
        self.moved_ops: dict[str, int] = {}

    def record(self, hop: str, kind: str, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            if kind == COPIED:
                self.copied_bytes[hop] = self.copied_bytes.get(hop, 0) + nbytes
                self.copied_ops[hop] = self.copied_ops.get(hop, 0) + 1
            else:
                self.moved_bytes[hop] = self.moved_bytes.get(hop, 0) + nbytes
                self.moved_ops[hop] = self.moved_ops.get(hop, 0) + 1

    def snapshot(self) -> dict:
        """{"hops": {hop: {"copied_bytes": b, "copied_ops": n,
        "moved_bytes": b, "moved_ops": n}}} -- mergeable across nodes."""
        with self._lock:
            cb, co = dict(self.copied_bytes), dict(self.copied_ops)
            mb, mo = dict(self.moved_bytes), dict(self.moved_ops)
        hops: dict[str, dict] = {}
        for hop in sorted(set(cb) | set(mb)):
            hops[hop] = {
                "copied_bytes": cb.get(hop, 0),
                "copied_ops": co.get(hop, 0),
                "moved_bytes": mb.get(hop, 0),
                "moved_ops": mo.get(hop, 0),
            }
        return {"hops": hops}

    @staticmethod
    def merge(snaps: list[dict]) -> dict:
        out: dict[str, dict] = {}
        for snap in snaps:
            for hop, row in (snap or {}).get("hops", {}).items():
                dst = out.setdefault(hop, {
                    "copied_bytes": 0, "copied_ops": 0,
                    "moved_bytes": 0, "moved_ops": 0,
                })
                for k in dst:
                    dst[k] += int(row.get(k, 0))
        return {"hops": out}

    def reset(self) -> None:
        with self._lock:
            self.copied_bytes.clear()
            self.copied_ops.clear()
            self.moved_bytes.clear()
            self.moved_ops.clear()


# -- process singleton ---------------------------------------------------------


class ProfilerSys:
    """The always-on profiling plane: copy ledger (armed from import --
    it is passive counters), continuous sampler + GIL probe (armed by
    ensure_started(); MTPU_PROFILE=0 vetoes). One per process; nodes
    sharing the process share it, like GLOBAL_PERF."""

    def __init__(self):
        self.copy = CopyLedger()
        self._lock = san_lock("ProfilerSys._lock")
        self.sampler: ContinuousProfiler | None = None
        self.gil: GilLoadProbe | None = None

    @property
    def armed(self) -> bool:
        s = self.sampler
        return s is not None and s.running

    def ensure_started(
        self,
        interval_s: float | None = None,
        window_s: float | None = None,
        max_windows: int | None = None,
    ) -> bool:
        """Idempotently start the sampler + GIL probe threads. Returns
        whether the plane is running (False when MTPU_PROFILE=0)."""
        if os.environ.get("MTPU_PROFILE", "") == "0":
            return False
        with self._lock:
            if self.sampler is None:
                self.sampler = ContinuousProfiler(
                    interval_s=interval_s if interval_s is not None else 0.010,
                    window_s=window_s if window_s is not None else 60.0,
                    max_windows=max_windows if max_windows is not None else 5,
                )
            if self.gil is None:
                self.gil = GilLoadProbe()
            self.sampler.start()
            self.gil.start()
        return True

    def stop(self) -> None:
        """Stop the sampler/probe threads (teardown hook: Node.close_all
        and the test-session fixture). Counters and windows survive."""
        with self._lock:
            if self.sampler is not None:
                self.sampler.stop()
            if self.gil is not None:
                self.gil.stop()

    def gil_load(self) -> float:
        g = self.gil
        return g.value() if g is not None else 0.0

    # -- read side ---------------------------------------------------------

    def snapshot(self, top: int = 40, include_stacks: bool = True) -> dict:
        """The /mtpu/admin/v1/profile payload for ONE node; peers ship
        these for the ?cluster=1 merge (merge_profiles)."""
        s = self.sampler
        out = {
            "profile": 1,
            "armed": self.armed,
            "gil_load": round(self.gil_load(), 4),
            "copy": self.copy.snapshot(),
        }
        if s is not None:
            out["sampler"] = {
                "interval_ms": round(s.interval_s * 1e3, 3),
                "window_s": s.window_s,
                "windows_rotated": s.windows_rotated,
                "overhead_ratio": round(s.overhead_ratio(), 6),
            }
            out["windows"] = s.windows(top=top if include_stacks else -1)
            if not include_stacks:
                for w in out["windows"]:
                    w.pop("stacks", None)
        return out

    def summary(self, top: int = 5) -> dict:
        """Compact block for loadgen/bench reports: gil_load, top role
        stacks across retained windows, overhead, copy ledger."""
        s = self.sampler
        merged: Counter[str] = Counter()
        roles: Counter[str] = Counter()
        samples = 0
        if s is not None:
            for w in s.windows(top=0):
                merged.update(w["stacks"])
                roles.update(w["roles"])
                samples += w["samples"]
        total = sum(merged.values())
        return {
            "armed": self.armed,
            "gil_load": round(self.gil_load(), 4),
            "samples": samples,
            "sampler_overhead_ratio": (
                round(s.overhead_ratio(), 6) if s is not None else 0.0
            ),
            "roles": dict(roles),
            "top_stacks": [
                {
                    "stack": k,
                    "samples": n,
                    "share": round(n / total, 4) if total else 0.0,
                }
                for k, n in merged.most_common(top)
            ],
            "copy": self.copy.snapshot()["hops"],
        }


def merge_profiles(snaps: list[dict]) -> dict:
    """Cluster view of per-node snapshot() payloads: stack/role counters
    summed across every node's windows, copy ledgers merged, per-node
    gil_load kept (GIL pressure is per-interpreter -- summing it would
    manufacture a number with no meaning)."""
    stacks: Counter[str] = Counter()
    roles: Counter[str] = Counter()
    samples = 0
    gil: dict[str, float] = {}
    copies: list[dict] = []
    for i, snap in enumerate(snaps):
        if not snap:
            continue
        node = str(snap.get("node", i))
        gil[node] = float(snap.get("gil_load", 0.0))
        copies.append(snap.get("copy", {}))
        for w in snap.get("windows", ()) or ():
            stacks.update(w.get("stacks", {}))
            roles.update(w.get("roles", {}))
            samples += int(w.get("samples", 0))
    return {
        "samples": samples,
        "gil_load": gil,
        "roles": dict(roles),
        "stacks": dict(stacks),
        "copy": CopyLedger.merge(copies),
    }


GLOBAL_PROFILER = ProfilerSys()
