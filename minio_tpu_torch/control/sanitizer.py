"""mtpusan runtime half: a lockdep-style concurrency sanitizer.

The dynamic complement of tools/mtpulint (static) and tools/race_gate.py
(schedule stress): where the race gate hopes a latent race *fires*, this
module proves ordering properties about the runs that DIDN'T deadlock --
the Go `-race` / Linux lockdep role for this codebase.

Armed with ``MTPU_TSAN=1`` (or ``arm()``), the ``san_lock`` / ``san_rlock``
/ ``san_condition`` factories -- swapped in at every lock construction site
across the data plane -- return instrumented primitives that record, per
thread, the stack of currently-held locks and feed a process-global
lock-order graph keyed by construction-site *name* (lockdep's lock-class
semantics: every ``object/metacache.py`` instance shares one node). From
that the sanitizer reports:

  * ``lock-order-inversion`` -- a new A->B acquisition edge that closes a
    cycle in the graph: a potential deadlock, reported even though this
    run's interleaving never wedged;
  * ``self-deadlock`` -- re-acquiring a non-reentrant lock the SAME thread
    already holds (raised immediately instead of hanging the suite);
  * ``lock-held-long`` -- a lock held past ``MTPU_TSAN_HOLD_MS`` (default
    200 ms): the runtime complement of mtpulint's static lock-blocking-io;
  * ``lock-over-blocking`` -- ``time.sleep`` called while holding any
    sanitized lock (the sleep seam is patched while armed);
  * ``cond-wait-no-loop`` -- ``Condition.wait()`` from a call site that is
    not lexically inside a ``while`` predicate loop (spurious wakeups);
  * ``leaked-thread`` / ``fd-leak`` -- threads/file descriptors alive at
    ``teardown_check()`` that did not exist when the sanitizer armed.

Disarmed (the default), the factories return the plain ``threading``
primitives -- no wrapper object, no extra attribute loads, nothing on the
hot path; tests assert the pass-through by type identity. Every finding
carries a stable ``site`` key so the shrink-only baseline
(``tools/mtpusan_baseline.txt``) and the in-code SUPPRESSIONS table work
exactly like mtpulint's: fix the bug or justify the exemption, never bury
it.

The per-lock contention/hold-time profile (``GLOBAL_SAN.profile()``) is the
measurement ROADMAP item 1 starts from: which locks serialize the
concurrent-PUT path, how long they are held, and how often acquirers had to
wait. ``tools/mtpusan.py`` injects it into the loadgen scenario report.

Pure stdlib, imports nothing from the project: any module may pull the
factories without cycles, and arming cannot drag accelerator deps in.
"""

from __future__ import annotations

import ast
import atexit
import json
import os
import sys
import threading
import time
import traceback

# ---------------------------------------------------------------------------
# Declared lock ordering (outermost first). Consumed two ways:
#   * statically by tools/mtpulint's `lock-order` rule: a lexically nested
#     `with` pair whose (outer, inner) contradicts this order is a finding;
#   * as documentation of the canonical hierarchy for the data plane.
# Names are the static qualified form `ClassName.attr` (module-level locks
# use `filestem.attr`). Only pairs where BOTH ends appear here are checked
# against the order; everything else is covered by graph cycle detection.
# ---------------------------------------------------------------------------
LOCK_ORDER: tuple[str, ...] = (
    "IAMSys._mutate_lock",     # IAM admin mutation serialization ...
    "IAMSys._lock",            # ... wraps the IAM state lock
    "BatchingDeviceCodec._lock",       # worker/pipeline management ...
    "BatchingDeviceCodec._stats_lock", # ... may publish stats inside
    "runtime._probe_once_lock",  # probe single-flight ...
    "runtime._probe_lock",       # ... wraps the verdict/transition state
    # Data-plane pool locks are LEAVES: they guard queue/free-list
    # bookkeeping only (never I/O, never another lock). Any lock may wrap
    # them; they wrap nothing.
    "LanePool._lock",          # drive-I/O lane queues (utils/iopool.py)
    "BufferPool._lock",        # window free list + refcounts (utils/bufpool.py)
)

_HOLD_MS_DEFAULT = 200.0
_FD_LEAK_SLACK = 64
_STACK_LIMIT = 12
# teardown_check() grants lingering threads this long to finish exiting
# before calling them leaked: a stop path may legitimately still be joining
# its worker (e.g. an MRF heal in flight against already-dead peers when
# shutdown landed). A genuinely unjoined daemon loops forever and outlives
# any grace. Tests shrink it via MTPU_TSAN_GRACE_MS to stay fast.
_TEARDOWN_GRACE_S = float(os.environ.get("MTPU_TSAN_GRACE_MS", "2000")) / 1000.0

# Deliberate, justified exemptions: (rule, site substring, why). A matching
# finding still appears in the report (audit trail) but carries the reason
# and does not fail the gate. Adding a row here is a reviewed decision,
# exactly like an mtpulint inline suppression.
SUPPRESSIONS: tuple[tuple[str, str, str], ...] = (
    ("leaked-thread", "lock-refresh",
     "process-wide DRWMutex refresh daemon (dist/locks.py): one singleton "
     "sweeping all held locks for the process lifetime, by design"),
    ("leaked-thread", "codec-warmup",
     "bounded one-shot device warmup (runtime.py); exits on its own"),
    ("leaked-thread", "codec-probe",
     "bounded one-shot probe started by runtime.start_probe; exits on its own"),
    ("leaked-thread", "http-server",
     "uvicorn serving thread lives for the process (cli.py serve)"),
    ("leaked-thread", "pytest_timeout",
     "pytest-timeout watchdog thread, not project code"),
    ("leaked-thread", "prof-continuous",
     "always-on continuous profiling sampler (control/profiler.py): one "
     "process singleton; GLOBAL_PROFILER.stop() is the teardown hook"),
    ("leaked-thread", "gil-probe",
     "always-on GIL-load probe (control/profiler.py): one process "
     "singleton; GLOBAL_PROFILER.stop() is the teardown hook"),
    ("leaked-thread", "asyncio_",
     "asyncio default executor worker owned by the event loop"),
    ("leaked-thread", "drive-io",
     "process-wide drive I/O worker pools (object/metadata.py _POOL "
     "'drive-io' and utils/iopool.py 'drive-io-lane'): singletons shared by "
     "every PUT's shard fan-out, alive for the process by design"),
    ("leaked-thread", "put-stager",
     "PUT readahead stage (object/erasure.py _ReadaheadWindows): joined by "
     "windows.close() on every exit path; a straggler here is one bounded "
     "fill finishing, not an unjoined loop"),
    ("lock-held-long", "IAMSys._mutate_lock",
     "IAM mutations serialize the whole refresh->apply->persist cycle "
     "(including cluster IAM lock RPCs and store writes) under one barrier "
     "by design -- a peer reload landing mid-cycle would resurrect the "
     "pre-mutation snapshot; rare control-plane path"),
    ("lock-held-long", "runtime._probe_once_lock",
     "single-flight device-probe barrier: holding across the bounded child "
     "process IS the design -- concurrent booters must wait for the first "
     "probe's result instead of forking a probe swarm (cold path, once per "
     "process)"),
    ("lock-over-blocking", "subprocess.py",
     "Popen.wait()'s internal poll sleep under the single-flight probe "
     "barrier (runtime._probe_once_lock): the 'blocking work' is the "
     "bounded child-process wait that barrier exists to serialize"),
)


def _now() -> float:
    return time.perf_counter()


def _stack(skip: int = 2, limit: int = _STACK_LIMIT) -> list[str]:
    """Cheap acquisition stack: file:line:func strings, no source lookup."""
    out: list[str] = []
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover - shallow stack
        return out
    while f is not None and len(out) < limit:
        co = f.f_code
        out.append(f"{co.co_filename}:{f.f_lineno}:{co.co_name}")
        f = f.f_back
    return out


def _caller_site(skip: int = 2) -> str:
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class _Held:
    """One acquisition on a thread's held stack."""

    __slots__ = ("lock", "name", "t_acquire", "stack")

    def __init__(self, lock, name: str, t_acquire: float, stack: list[str]):
        self.lock = lock
        self.name = name
        self.t_acquire = t_acquire
        self.stack = stack


class Sanitizer:
    """Process-global sanitizer state: graph, stats, findings.

    The internal meta-lock is a PLAIN threading.Lock (never a SanLock --
    instrumenting the instrument would recurse) and every critical section
    under it is a few dict operations; user locks are never acquired while
    it is held, so the sanitizer cannot introduce ordering of its own.
    """

    def __init__(self, hold_threshold_s: float | None = None):
        self._mu = threading.Lock()
        self.hold_threshold_s = (
            hold_threshold_s
            if hold_threshold_s is not None
            else float(os.environ.get("MTPU_TSAN_HOLD_MS", _HOLD_MS_DEFAULT)) / 1000.0
        )
        self._tls = threading.local()
        # (a, b) -> {"count", "stack_out", "stack_in"}: a held while b taken.
        self.edges: dict[tuple[str, str], dict] = {}
        self.succ: dict[str, set[str]] = {}
        # name -> aggregate acquisition/hold/contention counters.
        self.lock_stats: dict[str, dict] = {}
        self.findings: list[dict] = []
        self._finding_keys: set[tuple[str, str]] = set()
        self._baseline_threads: set[int] = set()
        self._baseline_fds = 0
        self._cycle_pairs: set[frozenset] = set()

    # -- thread-local held stack --------------------------------------------

    def held(self) -> list[_Held]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def held_names(self) -> list[str]:
        return [h.name for h in self.held()]

    # -- findings ------------------------------------------------------------

    def add_finding(
        self, rule: str, site: str, message: str, stacks: list[list[str]] | None = None
    ) -> None:
        key = (rule, site)
        with self._mu:
            if key in self._finding_keys:
                return
            self._finding_keys.add(key)
            row: dict = {"rule": rule, "site": site, "message": message}
            if stacks:
                row["stacks"] = stacks
            for s_rule, s_sub, why in SUPPRESSIONS:
                if rule == s_rule and s_sub in site:
                    row["suppressed"] = why
                    break
            self.findings.append(row)

    # -- lock-order graph ----------------------------------------------------

    def record_edge(self, outer: _Held, inner_name: str, inner_stack: list[str]) -> None:
        """Thread holds `outer` and just acquired `inner_name`."""
        a, b = outer.name, inner_name
        if a == b:
            return
        with self._mu:
            edge = self.edges.get((a, b))
            if edge is not None:
                edge["count"] += 1
                return
            self.edges[(a, b)] = {
                "count": 1, "stack_out": outer.stack, "stack_in": inner_stack,
            }
            self.succ.setdefault(a, set()).add(b)
            # New edge a->b: if b already reaches a, the graph now has a
            # cycle -- a potential deadlock that never needs to fire.
            path = self._path_locked(b, a)
            if path is None:
                return
            pair = frozenset((a, b))
            if pair in self._cycle_pairs:
                return
            self._cycle_pairs.add(pair)
            cycle = [a, b] + path[1:]
            rev = self.edges.get((b, a))
        if path is not None:
            stacks = [inner_stack]
            if rev is not None:
                stacks.append(rev["stack_in"])
            self.add_finding(
                "lock-order-inversion",
                "->".join(sorted((a, b))),
                "lock-order cycle: " + " -> ".join(cycle)
                + " (threads taking these in opposite orders can deadlock)",
                stacks=stacks,
            )

    def _path_locked(self, src: str, dst: str) -> list[str] | None:
        """BFS path src..dst over succ; caller holds self._mu."""
        if src == dst:
            return [src]
        prev: dict[str, str] = {src: src}
        frontier = [src]
        while frontier:
            nxt: list[str] = []
            for u in frontier:
                for v in self.succ.get(u, ()):
                    if v in prev:
                        continue
                    prev[v] = u
                    if v == dst:
                        path = [v]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    nxt.append(v)
            frontier = nxt
        return None

    # -- per-lock stats ------------------------------------------------------

    def note_acquire(self, name: str, wait_s: float, contended: bool) -> None:
        with self._mu:
            st = self.lock_stats.get(name)
            if st is None:
                st = self.lock_stats[name] = {
                    "acquisitions": 0, "contended": 0, "wait_s": 0.0,
                    "hold_s": 0.0, "hold_max_s": 0.0,
                }
            st["acquisitions"] += 1
            st["wait_s"] += wait_s
            if contended:
                st["contended"] += 1

    def note_release(self, name: str, hold_s: float, stack: list[str]) -> None:
        with self._mu:
            st = self.lock_stats.get(name)
            if st is not None:
                st["hold_s"] += hold_s
                if hold_s > st["hold_max_s"]:
                    st["hold_max_s"] = hold_s
        if hold_s > self.hold_threshold_s:
            self.add_finding(
                "lock-held-long",
                name,
                f"lock {name!r} held {hold_s * 1000:.1f} ms "
                f"(threshold {self.hold_threshold_s * 1000:.0f} ms) -- "
                "move the blocking work outside the critical section",
                stacks=[stack],
            )

    # -- arm-time snapshot / teardown ---------------------------------------

    def snapshot_baseline(self) -> None:
        self._baseline_threads = {
            t.ident for t in threading.enumerate() if t.ident is not None
        }
        self._baseline_fds = _fd_count()

    def teardown_check(self) -> None:
        """Report threads/fds that appeared since arming and are still alive.

        Call AFTER the harness has shut its components down (e.g. a pytest
        sessionfinish hook): anything left is a worker whose stop path never
        joined it -- the unjoined-daemon class of leak."""
        me = threading.current_thread()

        def _lingering() -> list[threading.Thread]:
            return [
                t for t in threading.enumerate()
                if t is not me and t.is_alive()
                and not (t.ident is not None and t.ident in self._baseline_threads)
            ]

        # Bounded grace before judging: join each straggler against a shared
        # deadline. Suppressed-by-design daemons (lock-refresh, ...) are
        # skipped -- they never exit, and stalling on them would make every
        # armed teardown pay the full grace for nothing.
        deadline = time.monotonic() + _TEARDOWN_GRACE_S
        for t in _lingering():
            if any(rule == "leaked-thread" and frag in t.name
                   for rule, frag, _ in SUPPRESSIONS):
                continue
            try:
                t.join(max(0.0, deadline - time.monotonic()))
            except RuntimeError:  # foreign/_DummyThread: cannot be joined
                pass
        for t in _lingering():
            self.add_finding(
                "leaked-thread",
                t.name,
                f"thread {t.name!r} (daemon={t.daemon}) still alive at "
                "teardown -- its owner's stop/close path never joined it",
            )
        fds = _fd_count()
        if self._baseline_fds and fds > self._baseline_fds + _FD_LEAK_SLACK:
            self.add_finding(
                "fd-leak",
                "process",
                f"fd count grew {self._baseline_fds} -> {fds} "
                f"(slack {_FD_LEAK_SLACK}) between arm and teardown",
            )

    # -- reporting -----------------------------------------------------------

    def profile(self) -> dict:
        """Per-lock contention/hold-time profile, worst hold first."""
        with self._mu:
            rows = {
                name: {
                    "acquisitions": st["acquisitions"],
                    "contended": st["contended"],
                    "contention_rate": round(
                        st["contended"] / st["acquisitions"], 4
                    ) if st["acquisitions"] else 0.0,
                    "wait_s": round(st["wait_s"], 6),
                    "hold_s": round(st["hold_s"], 6),
                    "hold_max_s": round(st["hold_max_s"], 6),
                }
                for name, st in self.lock_stats.items()
            }
        return dict(
            sorted(rows.items(), key=lambda kv: -kv[1]["hold_s"])
        )

    def report(self) -> dict:
        with self._mu:
            findings = [dict(f) for f in self.findings]
            n_edges = len(self.edges)
        return {
            "mtpusan": 1,
            "armed": armed(),
            "hold_threshold_ms": round(self.hold_threshold_s * 1000, 1),
            "findings": findings,
            "unsuppressed": sum(1 for f in findings if "suppressed" not in f),
            "lock_order_edges": n_edges,
            "lock_profile": self.profile(),
        }

    def write_report(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:  # pragma: no cover - non-procfs platform
        return 0


# ---------------------------------------------------------------------------
# Instrumented primitives
# ---------------------------------------------------------------------------


class SanLock:
    """threading.Lock wrapper feeding the sanitizer. API-compatible with
    the subset this codebase uses (acquire/release/locked/context manager)."""

    _reentrant = False

    def __init__(self, san: Sanitizer, name: str):
        self._san = san
        self.name = name
        self._inner = self._make_inner()
        self._owner: int | None = None
        self._depth = 0

    def _make_inner(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        san = self._san
        me = threading.get_ident()
        if self._owner == me:
            if self._reentrant:
                self._depth += 1
                self._inner.acquire()
                return True
            san.add_finding(
                "self-deadlock",
                self.name,
                f"thread re-acquiring non-reentrant lock {self.name!r} it "
                "already holds -- this deadlocks un-sanitized",
                stacks=[_stack()],
            )
            raise RuntimeError(
                f"mtpusan: self-deadlock on {self.name!r} (see findings)"
            )
        stack = _stack()
        held = san.held()
        t0 = _now()
        got = self._inner.acquire(False)
        contended = not got
        if not got:
            if not blocking:
                san.note_acquire(self.name, 0.0, True)
                return False
            if timeout is not None and timeout > 0:
                got = self._inner.acquire(True, timeout)
            else:
                got = self._inner.acquire()
            if not got:
                san.note_acquire(self.name, _now() - t0, True)
                return False
        wait = _now() - t0
        self._owner = me
        self._depth = 1
        for h in held:
            san.record_edge(h, self.name, stack)
        held.append(_Held(self, self.name, _now(), stack))
        san.note_acquire(self.name, wait, contended)
        return True

    def release(self) -> None:
        san = self._san
        self._depth -= 1
        if self._depth <= 0:
            self._owner = None
            held = san.held()
            for i in range(len(held) - 1, -1, -1):
                if held[i].lock is self:
                    h = held.pop(i)
                    san.note_release(self.name, _now() - h.t_acquire, h.stack)
                    break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<SanLock {self.name!r} held_by={self._owner}>"


class SanRLock(SanLock):
    """Reentrant variant: order edges/stats only on the outermost entry."""

    _reentrant = True

    def _make_inner(self):
        return threading.RLock()


class SanCondition:
    """threading.Condition wrapper: checks that bare wait() call sites sit
    inside a `while` predicate loop (wait_for carries its own loop)."""

    def __init__(self, san: Sanitizer, name: str, lock=None):
        self._san = san
        self.name = name
        self._cond = threading.Condition(lock)

    def wait(self, timeout: float | None = None) -> bool:
        try:
            f = sys._getframe(1)
            fname, lineno = f.f_code.co_filename, f.f_lineno
        except ValueError:  # pragma: no cover
            fname, lineno = "?", 0
        if fname != "?" and not _line_in_while(fname, lineno):
            self._san.add_finding(
                "cond-wait-no-loop",
                f"{os.path.basename(fname)}:{lineno}",
                f"Condition.wait() on {self.name!r} outside a `while "
                "predicate:` loop -- spurious wakeups and missed notifies "
                "break this; re-check the predicate in a loop or use "
                "wait_for()",
            )
        # mtpulint: disable=cond-wait-loop -- delegation, not a use site: the
        # predicate-loop obligation belongs to OUR caller, checked above.
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def acquire(self, *a, **kw):
        return self._cond.acquire(*a, **kw)

    def release(self) -> None:
        self._cond.release()

    def __enter__(self):
        self._cond.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cond.__exit__(*exc)


_WHILE_SPANS_CACHE: dict[str, list[tuple[int, int]]] = {}
_WHILE_CACHE_LOCK = threading.Lock()


def _line_in_while(filename: str, lineno: int) -> bool:
    """True when `lineno` of `filename` falls inside any `while` body."""
    with _WHILE_CACHE_LOCK:
        spans = _WHILE_SPANS_CACHE.get(filename)
    if spans is None:
        spans = []
        try:
            with open(filename, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=filename)
            for node in ast.walk(tree):
                if isinstance(node, ast.While):
                    spans.append((node.lineno, node.end_lineno or node.lineno))
        except (OSError, SyntaxError, ValueError):
            # Unreadable source (REPL, zipapp): give wait() the benefit of
            # the doubt rather than minting unverifiable findings.
            spans = [(0, 1 << 60)]
        with _WHILE_CACHE_LOCK:
            _WHILE_SPANS_CACHE[filename] = spans
    return any(lo <= lineno <= hi for lo, hi in spans)


# ---------------------------------------------------------------------------
# Arming and the factory seam
# ---------------------------------------------------------------------------

GLOBAL_SAN = Sanitizer()
_ARMED = False
_real_sleep = None


def armed() -> bool:
    return _ARMED


def _san_sleep(secs):
    held = GLOBAL_SAN.held_names()
    if held:
        GLOBAL_SAN.add_finding(
            "lock-over-blocking",
            _caller_site(),
            f"time.sleep({secs!r}) while holding {held} -- sleeping under a "
            "lock convoys every other acquirer",
            stacks=[_stack()],
        )
    return _real_sleep(secs)


def arm(san: Sanitizer | None = None) -> Sanitizer:
    """Arm the sanitizer (idempotent). Locks constructed BEFORE arming stay
    plain -- set MTPU_TSAN=1 in the environment so module import order
    cannot race the swap."""
    global GLOBAL_SAN, _ARMED, _real_sleep
    if san is not None:
        GLOBAL_SAN = san
    if not _ARMED:
        _ARMED = True
        GLOBAL_SAN.snapshot_baseline()
        _real_sleep = time.sleep
        time.sleep = _san_sleep
    return GLOBAL_SAN


def disarm() -> None:
    global _ARMED, _real_sleep
    if _ARMED:
        _ARMED = False
        if _real_sleep is not None:
            time.sleep = _real_sleep
            _real_sleep = None


def san_lock(name: str = ""):
    """A mutex for the data plane. Disarmed: a plain threading.Lock (zero
    overhead). Armed: a SanLock feeding the lock-order graph under `name`
    (defaults to the construction call site)."""
    if not _ARMED:
        return threading.Lock()
    return SanLock(GLOBAL_SAN, name or _caller_site())


def san_rlock(name: str = ""):
    if not _ARMED:
        return threading.RLock()
    return SanRLock(GLOBAL_SAN, name or _caller_site())


def san_condition(name: str = "", lock=None):
    if not _ARMED:
        return threading.Condition(lock)
    return SanCondition(GLOBAL_SAN, name or _caller_site(), lock)


def profile_if_armed() -> dict | None:
    """The per-lock contention profile, or None when disarmed (loadgen
    embeds this into the scenario report JSON)."""
    return GLOBAL_SAN.profile() if _ARMED else None


def _atexit_dump() -> None:  # pragma: no cover - exercised via subprocess
    out = os.environ.get("MTPU_TSAN_OUT")
    if not out or not _ARMED:
        return
    try:
        GLOBAL_SAN.teardown_check()
        GLOBAL_SAN.write_report(out)
    except OSError as e:
        print(f"mtpusan: could not write report to {out}: {e}", file=sys.stderr)


if os.environ.get("MTPU_TSAN") == "1":
    arm()
    atexit.register(_atexit_dump)
