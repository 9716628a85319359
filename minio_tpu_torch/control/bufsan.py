"""bufsan runtime half: a buffer-lifetime sanitizer for the zero-copy pool.

The dynamic complement of the tools/mtpulint buffer rules (`view-escape`,
`release-on-all-paths`, `double-release`): where the static rules prove
lifetime discipline about code paths that never ran, this module catches
the bugs that only exist at runtime -- a `memoryview` held past the last
``release()``, a write landing in storage that already went back to the
free list, a handle dropped on the floor with its refcount still positive.

The reference gets all of this for free from Go's GC; our zero-copy plane
(``utils/bufpool.py``) reintroduced manual lifetime management, and
``PooledBuffer.view`` itself warns that a stale view silently reads
*another request's* recycled bytes -- a data-corruption class, not a crash
class. bufsan turns that silent corruption into a named finding.

Armed with ``MTPU_BUFSAN=1`` (or ``arm()``), ``BufferPool`` feeds every
lifecycle event through the hooks below:

  * each acquisition is tagged with its construction site (``file.py:line``
    above the pool, mtpusan's lock-class convention) and a weakref so a
    handle garbage-collected with a positive refcount reports
    ``buffer-leak`` instead of silently leaking the outstanding count;
  * storage returning to the free list is filled with a rotating sentinel
    byte; on re-acquire the sentinel is verified (stride-sampled, knob
    ``MTPU_BUFSAN_SAMPLE``) -- a mismatch is a ``write-after-release``
    naming the previous owner's acquire site;
  * at the last release the storage is probed for live ``memoryview``
    exports (a bytearray with exports refuses to resize -- CPython's
    ob_exports check -- backed by a ``sys.getrefcount`` delta taken at
    acquire time); a live export is ``view-outlives-buffer``, naming the
    sites that created the still-live views;
  * releasing below zero is ``double-release`` (recorded, then the pool's
    RuntimeError still raises).

Disarmed (the default), ``ACTIVE`` is ``None`` and the pool's hot path
pays one module-attribute load and an ``is None`` test per lifecycle event
-- the same zero-overhead discipline as the disarmed ``san_lock``.

Findings carry a stable ``site`` key so the shrink-only baseline
(``tools/bufsan_baseline.txt``) and the SUPPRESSIONS table work exactly
like mtpusan's: fix the bug or justify the exemption, never bury it. The
report JSON (``MTPU_BUFSAN_OUT``) mirrors ``MTPU_TSAN_OUT`` and is merged
by the ``tools/bufsan.py`` gate script.

Pure stdlib, imports nothing from the project: bufpool may pull the hooks
without cycles, and arming cannot drag accelerator deps in.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import weakref

_STACK_LIMIT = 12
# Frames inside these files are plumbing, not the acquisition site.
_OWN_FILES = ("bufpool.py", "bufsan.py")

# Rotating recycle sentinels: consecutive recycles of the same storage get
# different bytes, so a write-after-release cannot hide by writing the
# pattern it happened to read.
_SENTINELS: tuple[int, ...] = (0xA5, 0x5A, 0xC3, 0x3C)
# Sentinel fills copy from a cached pattern in 1 MiB strides (a 16 MiB
# window would otherwise mint a 16 MiB temp per recycle).
_PATTERN_BYTES = 1 << 20
# Verification samples this many positions per buffer (plus both ends);
# a full byte-for-byte check of a 16 MiB window per reuse would turn the
# sanitized replay into a memset benchmark.
_SAMPLE_POINTS = max(16, int(os.environ.get("MTPU_BUFSAN_SAMPLE", "256")))

# Deliberate, justified exemptions: (rule, site substring, why). A matching
# finding still appears in the report (audit trail) but carries the reason
# and does not fail the gate -- same contract as mtpusan.SUPPRESSIONS.
SUPPRESSIONS: tuple[tuple[str, str, str], ...] = ()


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


def _site(skip: int = 2) -> str:
    """First caller frame OUTSIDE the pool/sanitizer plumbing, as the
    stable `file.py:line` key findings and suppressions match on."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover
        return "?"
    while f is not None:
        base = os.path.basename(f.f_code.co_filename)
        if base not in _OWN_FILES:
            return f"{base}:{f.f_lineno}"
        f = f.f_back
    return "?"  # pragma: no cover - pool called from nowhere


def _fill_sentinel(storage: bytearray, pattern: bytes) -> None:
    n = len(storage)
    off = 0
    while off < n:
        step = min(_PATTERN_BYTES, n - off)
        storage[off:off + step] = pattern[:step]
        off += step


def _has_exports(storage: bytearray) -> bool:
    """True when live memoryviews reference `storage`: a bytearray with
    exports refuses to resize (CPython checks ob_exports on any length
    change), so a one-byte append/trim is an exact, cheap probe."""
    try:
        storage.append(0)
    except BufferError:
        return True
    del storage[-1]
    return False


class _HandleState:
    """bufsan's shadow of one PooledBuffer: where it came from, which view
    sites it spawned, whether its last release ever happened."""

    __slots__ = ("site", "stack", "pool", "rc0", "view_sites", "view_count",
                 "released")

    def __init__(self, site: str, stack: list[str], pool: str, rc0: int):
        self.site = site
        self.stack = stack
        self.pool = pool
        self.rc0 = rc0
        self.view_sites: list[str] = []
        self.view_count = 0
        self.released = False


class BufSanitizer:
    """Process-global buffer-lifetime sanitizer state.

    The internal meta-lock is a PLAIN threading.Lock (never a SanLock) and
    a strict LEAF: hooks run under BufferPool._lock, so taking any other
    lock here would hang ordering off the sanitizer itself.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self.findings: list[dict] = []
        self._finding_keys: set[tuple[str, str]] = set()
        # id(pb) -> (weakref-to-pb, state): live, not-yet-fully-released
        # handles. The weakref callback is the leak detector.
        self._live: dict[int, tuple[weakref.ref, _HandleState]] = {}
        # id(storage) -> (sentinel, owner site) for storage ON the free
        # list. Keys are stable while the pool holds the only reference.
        self._poisoned: dict[int, tuple[int, str]] = {}
        self._sentinel_i = 0
        self._patterns: dict[int, bytes] = {}
        self.counters = {
            "acquires": 0,
            "views": 0,
            "recycles": 0,
            "sentinel_fills": 0,
            "sentinel_checks": 0,
        }

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

    # -- pool hooks (called by utils/bufpool.py when armed) ------------------

    def note_acquire(self, pb, pool_name: str, reused: bool) -> None:
        """Tag the new handle with its acquisition site; if the storage came
        off the free list, verify the recycle sentinel survived."""
        storage = pb.data
        site = _site()
        st = _HandleState(site, _stack(), pool_name, sys.getrefcount(storage))
        pb._san = st
        key = id(pb)
        wr = weakref.ref(pb, lambda _r, k=key: self._on_collected(k))
        poisoned = None
        with self._mu:
            self.counters["acquires"] += 1
            self._live[key] = (wr, st)
            if reused:
                poisoned = self._poisoned.pop(id(storage), None)
        if poisoned is not None:
            self._verify_sentinel(storage, poisoned[0], poisoned[1], site)

    def note_view(self, pb) -> None:
        st = getattr(pb, "_san", None)
        site = _site()
        with self._mu:
            self.counters["views"] += 1
            if st is not None:
                st.view_count += 1
                if len(st.view_sites) < 8 and site not in st.view_sites:
                    st.view_sites.append(site)

    def note_recycle(self, pb, storage: bytearray, pooled: bool) -> None:
        """Last release: probe for views that outlive the buffer, then (for
        storage headed back to the free list) poison it with the next
        sentinel. Runs under BufferPool._lock -- keep it allocation-light.

        The export probe only gates POOLED storage: a discarded or
        odd-size storage is never handed to another request, so a
        traceback-pinned view over it is plain garbage-collected memory,
        not a corruption hazard (that is exactly what discard() is for)."""
        st = getattr(pb, "_san", None)
        with self._mu:
            self.counters["recycles"] += 1
        if pooled and _has_exports(storage):
            site = st.site if st is not None else _site()
            extra = ""
            if st is not None:
                rc_delta = sys.getrefcount(storage) - st.rc0
                made = ", ".join(st.view_sites) or "untracked sites"
                extra = (
                    f" ({st.view_count} view(s) created at {made}; "
                    f"refcount delta vs acquire {rc_delta:+d})"
                )
            self.add_finding(
                "view-outlives-buffer",
                site,
                f"storage acquired at {site} still has live memoryview "
                f"exports at its last release{extra} -- the holder will "
                "read another request's recycled bytes; release the view "
                "before the buffer, or retain() the buffer for the view's "
                "lifetime",
                stacks=[st.stack] if st is not None else None,
            )
        if pooled:
            with self._mu:
                sentinel = _SENTINELS[self._sentinel_i % len(_SENTINELS)]
                self._sentinel_i += 1
                self.counters["sentinel_fills"] += 1
                self._poisoned[id(storage)] = (
                    sentinel, st.site if st is not None else "?")
                pattern = self._patterns.get(sentinel)
                if pattern is None:
                    pattern = self._patterns[sentinel] = (
                        bytes([sentinel]) * _PATTERN_BYTES)
            _fill_sentinel(storage, pattern)
        if st is not None:
            st.released = True
        with self._mu:
            self._live.pop(id(pb), None)

    def note_double_release(self, pb) -> None:
        st = getattr(pb, "_san", None)
        site = st.site if st is not None else _site()
        self.add_finding(
            "double-release",
            site,
            f"release() on an already-released PooledBuffer acquired at "
            f"{site} -- un-sanitized this corrupts the refcount of "
            "whoever re-acquired the storage",
            stacks=[_stack()],
        )

    # -- detectors -----------------------------------------------------------

    def _verify_sentinel(
        self, storage: bytearray, sentinel: int, owner_site: str, new_site: str
    ) -> None:
        with self._mu:
            self.counters["sentinel_checks"] += 1
        n = len(storage)
        if n == 0:  # pragma: no cover - pools never free-list empty storage
            return
        # Small storage is checked byte-for-byte (count() runs at C speed);
        # only multi-MiB windows pay the stride-sampling trade-off.
        if n <= (1 << 16):
            bad = None
            if storage.count(sentinel) != n:
                bad = next(i for i in range(n) if storage[i] != sentinel)
        else:
            step = max(1, n // _SAMPLE_POINTS)
            bad = next(
                (i for i in range(0, n, step) if storage[i] != sentinel), None)
            if bad is None and storage[n - 1] != sentinel:
                bad = n - 1
        if bad is not None:
            self.add_finding(
                "write-after-release",
                owner_site,
                f"storage released at {owner_site} was modified while on "
                f"the free list (byte {bad}: {storage[bad]:#04x} != "
                f"sentinel {sentinel:#04x}) -- a stale view or handle "
                f"wrote after the last release; re-acquired at {new_site}",
            )

    def _on_collected(self, key: int) -> None:
        """Weakref callback: the handle was garbage-collected. If its last
        release never ran, the outstanding count and (for overflow storage)
        the memory leaked with it."""
        with self._mu:
            row = self._live.pop(key, None)
        if row is None:
            return
        st = row[1]
        if not st.released:
            self.add_finding(
                "buffer-leak",
                st.site,
                f"PooledBuffer acquired at {st.site} (pool {st.pool!r}) "
                "was garbage-collected without its final release() -- "
                "the pool's outstanding count leaks and the storage is "
                "never recycled",
                stacks=[st.stack],
            )

    def teardown_check(self) -> None:
        """Report handles still un-released when the run tears down. Call
        AFTER the harness shut its components down: anything left is a
        buffer whose owner lost track of it."""
        with self._mu:
            live = list(self._live.values())
        for wr, st in live:
            if st.released or wr() is None:
                continue
            self.add_finding(
                "buffer-leak",
                st.site,
                f"PooledBuffer acquired at {st.site} (pool {st.pool!r}) "
                "still un-released at teardown -- its owner never reached "
                "the final release()",
                stacks=[st.stack],
            )

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        with self._mu:
            findings = [dict(f) for f in self.findings]
            counters = dict(self.counters)
            counters["poisoned_free"] = len(self._poisoned)
            counters["live_handles"] = len(self._live)
        return {
            "bufsan": 1,
            "armed": armed(),
            "sample_points": _SAMPLE_POINTS,
            "findings": findings,
            "unsuppressed": sum(1 for f in findings if "suppressed" not in f),
            "counters": counters,
        }

    def write_report(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Arming
# ---------------------------------------------------------------------------

GLOBAL_BUFSAN = BufSanitizer()
# The pool's hot-path gate: None when disarmed (one attribute load + is-None
# test per lifecycle event), the sanitizer instance when armed.
ACTIVE: BufSanitizer | None = None


def armed() -> bool:
    return ACTIVE is not None


def arm(san: BufSanitizer | None = None) -> BufSanitizer:
    """Arm the sanitizer (idempotent). Buffers acquired BEFORE arming carry
    no shadow state -- set MTPU_BUFSAN=1 in the environment so pool traffic
    cannot race the swap."""
    global GLOBAL_BUFSAN, ACTIVE
    if san is not None:
        GLOBAL_BUFSAN = san
    ACTIVE = GLOBAL_BUFSAN
    return GLOBAL_BUFSAN


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def _atexit_dump() -> None:  # pragma: no cover - exercised via subprocess
    out = os.environ.get("MTPU_BUFSAN_OUT")
    if not out or ACTIVE is None:
        return
    try:
        GLOBAL_BUFSAN.teardown_check()
        GLOBAL_BUFSAN.write_report(out)
    except OSError as e:
        print(f"bufsan: could not write report to {out}: {e}", file=sys.stderr)


if os.environ.get("MTPU_BUFSAN") == "1":
    arm()
    atexit.register(_atexit_dump)
