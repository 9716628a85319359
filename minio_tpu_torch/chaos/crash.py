"""Deterministic crash-point registry: named process-death points on the
commit path.

The fault registry (faults.py) injects drive *errors*; this module injects
*death*. A crash point is a named call site at a stage boundary of the PUT /
multipart / commit path (`crash_point("put.mid-commit", ...)`). Disarmed, the
call is one attribute-is-None check. Armed (through the same admin /chaos API as
FaultSpec, with ``kind: "crash"``), the registry kills the process at the
point -- ``os._exit``, no cleanup, no atexit, exactly what a worker crash or
``kill -9`` leaves behind -- so the recovery scan (storage/recovery.py) and
the crashcheck harness (tools/crashcheck.py) can prove the durability
invariants against every boundary, not just the ones a stress test happens
to hit.

Determinism mirrors FaultSpec: a spec fires on the (skip+1)-th matching hit,
and the torn-write point draws its cut offset from a private
``random.Random(seed)``, so a fixed (point, skip, seed) replays the same
crash schedule run after run.

Modes:
  * ``kill``       -- die at the point (default; exit code 137 = SIGKILL'd).
  * ``raise``      -- raise errors.CrashInjected instead of dying: the
                      in-process stand-in for worker death used by loadgen
                      scenarios and unit tests that must survive the "crash".
  * ``torn-kill``  -- (torn-capable points) truncate the write at a seeded
                      offset inside the last iovec, then die: the mid-writev
                      kill that leaves a short shard frame at rest.
  * ``torn``       -- truncate the same way but keep running: silent at-rest
                      corruption for the bitrot-detect -> heal tests.
"""

from __future__ import annotations

import os
import random
import uuid
from dataclasses import dataclass

from ..control.sanitizer import san_lock
from ..utils import errors

CRASH_KIND = "crash"  # FaultSpec-style kind the admin /chaos API routes here

KILL = "kill"
RAISE = "raise"
TORN_KILL = "torn-kill"
TORN = "torn"
MODES = frozenset({KILL, RAISE, TORN_KILL, TORN})

# Every registered crash point, one per stage boundary of the data path.
# tools/crashcheck.py enumerates this tuple; a new boundary is a two-line
# diff (the crash_point() call and its entry here), same contract as the
# perf-ledger STAGES registry.
KNOWN_POINTS: tuple = (
    # single-PUT streaming path (object/erasure.py _put_streaming)
    "put.after-stage",         # group appended (post-append_iov), pre-sync/drain
    "put.before-commit",       # shards staged + drained, xl.meta not written
    "put.mid-commit",          # inside the commit fan-out (skip = drives done)
    "put.after-commit",        # quorum committed, response not yet written
    # multipart path (object/multipart.py)
    "multipart.part.staged",   # part shards staged, publish rename pending
    "multipart.part.published",  # part renamed, part.meta not yet written
    "multipart.complete.mid-rename",  # some parts moved to the commit dir
    "multipart.complete.partial",     # complete fan-out, subset of drives done
    # storage commit internals (storage/local.py)
    "storage.rename-data.pre-meta",   # data dir renamed, xl.meta not written
    "storage.xlmeta.pre-replace",     # new xl.meta staged, os.replace pending
    "storage.append-iov.torn",        # mid-writev torn write (torn modes)
)

TORN_POINTS = frozenset({"storage.append-iov.torn"})


@dataclass
class CrashSpec:
    """One armed crash schedule. `skip` passes that many matching hits
    before firing; `target` substring-matches the drive endpoint (torn /
    storage points) -- "" matches everything."""

    point: str
    mode: str = KILL
    target: str = ""
    skip: int = 0
    seed: int = 0
    exit_code: int = 137
    fault_id: str = ""

    def __post_init__(self):
        if self.point not in KNOWN_POINTS:
            raise ValueError(
                f"unknown crash point {self.point!r} (want one of {list(KNOWN_POINTS)})"
            )
        if self.mode not in MODES:
            raise ValueError(f"unknown crash mode {self.mode!r} (want one of {sorted(MODES)})")
        if self.mode in (TORN, TORN_KILL) and self.point not in TORN_POINTS:
            raise ValueError(f"point {self.point!r} is not torn-capable")
        if self.skip < 0:
            raise ValueError("skip must be >= 0")

    @staticmethod
    def from_dict(doc: dict) -> "CrashSpec":
        if not isinstance(doc, dict) or "point" not in doc:
            raise ValueError("crash spec must be an object with a 'point'")
        return CrashSpec(
            point=str(doc["point"]),
            mode=str(doc.get("mode", KILL)),
            target=str(doc.get("target", "")),
            skip=int(doc.get("skip", 0)),
            seed=int(doc.get("seed", 0)),
            exit_code=int(doc.get("exit_code", 137)),
            fault_id=str(doc.get("fault_id", "")),
        )

    def to_dict(self) -> dict:
        return {
            "kind": CRASH_KIND,
            "point": self.point,
            "mode": self.mode,
            "target": self.target,
            "skip": self.skip,
            "seed": self.seed,
            "exit_code": self.exit_code,
            "fault_id": self.fault_id,
        }


class _ArmedCrash:
    __slots__ = ("spec", "rng", "skipped", "fired")

    def __init__(self, spec: CrashSpec):
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.skipped = 0
        self.fired = 0


class CrashRegistry:
    """Same hot-path shape as FaultRegistry: `points` is a tuple of armed
    crashes or None, read without the lock; every skip/fire decision is
    serialized under the lock so the i-th matching hit is the i-th draw."""

    def __init__(self):
        self._lock = san_lock("CrashRegistry._lock")
        self._armed: dict[str, _ArmedCrash] = {}
        self._fired: dict[str, int] = {}
        self.points: tuple | None = None

    def arm(self, spec: CrashSpec) -> str:
        fid = spec.fault_id or uuid.uuid4().hex[:12]
        spec.fault_id = fid
        with self._lock:
            self._armed[fid] = _ArmedCrash(spec)
            self._refresh()
        return fid

    def disarm(self, fault_id: str) -> bool:
        with self._lock:
            found = self._armed.pop(fault_id, None) is not None
            self._refresh()
        return found

    def disarm_all(self) -> int:
        with self._lock:
            n = len(self._armed)
            self._armed.clear()
            self._refresh()
        return n

    def list(self) -> list[dict]:
        with self._lock:
            return [
                {**a.spec.to_dict(), "skipped": a.skipped, "fired": a.fired}
                for a in self._armed.values()
            ]

    def fired_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._fired)

    def _refresh(self) -> None:
        self.points = tuple(self._armed.values()) or None

    # -- decisions -----------------------------------------------------------

    def _match(self, point: str, target: str, torn: bool):
        """First armed spec firing at this hit, decided under the lock.
        A fired kill/raise spec stays armed (the process is dead / the
        request aborted); torn specs keep firing for repeatability."""
        snap = self.points
        if snap is None:
            return None
        with self._lock:
            for a in snap:
                spec = a.spec
                if spec.point != point:
                    continue
                if torn != (spec.mode in (TORN, TORN_KILL)):
                    continue
                if spec.target and spec.target not in target:
                    continue
                if a.skipped < spec.skip:
                    a.skipped += 1
                    continue
                a.fired += 1
                self._fired[point] = self._fired.get(point, 0) + 1
                return a
        return None

    def hit(self, point: str, target: str = "") -> None:
        """Fire-or-pass for a plain (non-torn) crash point."""
        a = self._match(point, target, torn=False)
        if a is None:
            return
        if a.spec.mode == RAISE:
            raise errors.CrashInjected(point)
        die(a.spec.exit_code)

    def torn_hint(self, point: str, target: str, last_len: int):
        """(cut_offset_in_last_iov, kill_after) when a torn spec fires for
        this write, else None. The offset is the spec's seeded draw -- the
        i-th firing write is always cut at the i-th draw."""
        if last_len <= 0:
            return None
        a = self._match(point, target, torn=True)
        if a is None:
            return None
        return a.rng.randrange(last_len), a.spec.mode == TORN_KILL


def die(exit_code: int = 137) -> None:
    """Die like a crash: no stack unwind, no atexit, no flush of anything
    Python still holds. Bytes already handed to the kernel survive in page
    cache -- exactly the state a SIGKILL'd worker leaves on disk."""
    os._exit(exit_code)


# Process-global registry, armed by the admin /chaos API (kind "crash"),
# tools/crashcheck.py child processes, or MTPU_CRASH at boot.
REGISTRY = CrashRegistry()


def crash_point(point: str, target: str = "") -> None:
    """The instrumentation call sites use. Disarmed cost: one attribute
    load and a None check."""
    if REGISTRY.points is None:
        return
    REGISTRY.hit(point, target)


def torn_hint(point: str, target: str, last_len: int):
    """Torn-write decision for append_iov; None when disarmed."""
    if REGISTRY.points is None:
        return None
    return REGISTRY.torn_hint(point, target, last_len)


def arm_from_env(env: dict | None = None) -> list[str]:
    """Arm crash specs from ``MTPU_CRASH=point[:mode[:skip[:seed]]][,...]``.

    The env seam exists for processes the admin API can't reach in time:
    pre-fork workers arm at boot (every worker sees the same schedule), and
    crashcheck victim children arm before the workload starts. Malformed
    entries raise -- a crash schedule that silently half-arms would make a
    'passing' crashcheck run meaningless."""
    env = os.environ if env is None else env
    raw = str(env.get("MTPU_CRASH", "") or "").strip()
    if not raw:
        return []
    fids = []
    for entry in raw.split(","):
        parts = entry.strip().split(":")
        if not parts or not parts[0]:
            continue
        spec = CrashSpec(
            point=parts[0],
            mode=parts[1] if len(parts) > 1 and parts[1] else KILL,
            skip=int(parts[2]) if len(parts) > 2 and parts[2] else 0,
            seed=int(parts[3]) if len(parts) > 3 and parts[3] else 0,
        )
        fids.append(REGISTRY.arm(spec))
    return fids
