"""Fault registry: seeded, scoped, budgeted fault schedules.

A fault is a FaultSpec armed in a FaultRegistry. Every spec carries:

  * kind        -- what breaks (see DISK_KINDS / NET_KINDS below);
  * target      -- substring match against the drive endpoint (disk kinds)
                   or the peer base-url + request path (net kinds);
                   "" matches everything;
  * path        -- "bucket/prefix" filter for disk faults ("" = any);
  * ops         -- restrict to specific StorageAPI methods / RPC paths;
  * probability -- per-matching-call fire chance, drawn from the fault's
                   OWN random.Random(seed) so a fixed seed replays the
                   exact schedule;
  * count       -- injection budget (-1 = unlimited); exhausted faults
                   drop out of the hot-path snapshot;
  * delay_ms    -- sleep for latency / slow-rpc / hang kinds.

Determinism: each armed fault owns a private RNG seeded from its spec, and
every probability draw is serialized under the registry lock, so the i-th
matching call always sees the i-th draw. With a fixed seed and the same
call sequence the fired/skipped pattern is identical run to run.

Hot path: the registry keeps `disk` and `net` attributes that are either a
tuple of armed faults or None. Wrappers check `REGISTRY.disk is None` /
`REGISTRY.net is None` and fall straight through -- no allocation, no lock.
"""

from __future__ import annotations

import random
import threading
import uuid
from dataclasses import dataclass, field

from ..control import tracing
from ..control.sanitizer import san_lock, san_rlock

DRIVE_ERROR = "drive-error"
DRIVE_HANG = "drive-hang"
DRIVE_LATENCY = "drive-latency"
BITROT = "bitrot"
PARTITION = "partition"
SLOW_RPC = "slow-rpc"
LOCK_DEATH = "lock-death"

DISK_KINDS = frozenset({DRIVE_ERROR, DRIVE_HANG, DRIVE_LATENCY, BITROT})
NET_KINDS = frozenset({PARTITION, SLOW_RPC, LOCK_DEATH})
KINDS = DISK_KINDS | NET_KINDS

# lock-death only blackholes lock REST traffic; matched against the client
# base-url (dist/locks.py LOCK_PREFIX; literal here to keep this module
# import-free of dist/*, which imports us via transport).
_LOCK_PATH_MARKER = "/mtpu/lock/"

# Kinds that default to a restricted op set when spec.ops is empty: bitrot
# flips bytes on the SHARD WRITE path (post-checksum -- the frame digests
# were computed before the wrapper sees the bytes), so the corruption is
# at-rest and every later read fails HighwayHash verify until heal rewrites
# the shard. Arm with explicit ops=("read_file",) for read-side flips.
_DEFAULT_OPS = {BITROT: ("create_file", "append_file", "append_iov")}


@dataclass
class FaultSpec:
    kind: str
    target: str = ""
    path: str = ""
    ops: tuple = ()
    probability: float = 1.0
    count: int = -1
    delay_ms: float = 0.0
    seed: int = 0
    fault_id: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (want one of {sorted(KINDS)})")
        if not (0.0 < self.probability <= 1.0):
            raise ValueError("probability must be in (0, 1]")
        self.ops = tuple(self.ops or _DEFAULT_OPS.get(self.kind, ()))

    @staticmethod
    def from_dict(doc: dict) -> "FaultSpec":
        if not isinstance(doc, dict) or "kind" not in doc:
            raise ValueError("fault spec must be an object with a 'kind'")
        return FaultSpec(
            kind=str(doc["kind"]),
            target=str(doc.get("target", "")),
            path=str(doc.get("path", "")),
            ops=tuple(doc.get("ops", ()) or ()),
            probability=float(doc.get("probability", 1.0)),
            count=int(doc.get("count", -1)),
            delay_ms=float(doc.get("delay_ms", 0.0)),
            seed=int(doc.get("seed", 0)),
            fault_id=str(doc.get("fault_id", "")),
        )

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "target": self.target,
            "path": self.path,
            "ops": list(self.ops),
            "probability": self.probability,
            "count": self.count,
            "delay_ms": self.delay_ms,
            "seed": self.seed,
            "fault_id": self.fault_id,
        }


class _Armed:
    __slots__ = ("spec", "rng", "remaining", "injected")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.remaining = spec.count
        self.injected = 0


class FaultRegistry:
    def __init__(self):
        self._lock = san_lock("FaultRegistry._lock")
        self._armed: dict[str, _Armed] = {}
        self._injected: dict[tuple[str, str], int] = {}
        # Hot-path snapshots: tuple of live _Armed, or None when nothing of
        # that class is armed. Read without the lock (atomic attribute load).
        self.disk: tuple | None = None
        self.net: tuple | None = None

    # -- arm / disarm --------------------------------------------------------

    def arm(self, spec: FaultSpec) -> str:
        fid = spec.fault_id or uuid.uuid4().hex[:12]
        spec.fault_id = fid
        with self._lock:
            self._armed[fid] = _Armed(spec)
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
                {**a.spec.to_dict(), "remaining": a.remaining, "injected": a.injected}
                for a in self._armed.values()
            ]

    def injected_counts(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self._injected)

    def _refresh(self) -> None:
        """Rebuild hot-path snapshots (caller holds the lock). Exhausted
        budgets drop out so the wrappers return to pure pass-through."""
        live = [a for a in self._armed.values() if a.remaining != 0]
        disk = tuple(a for a in live if a.spec.kind in DISK_KINDS)
        net = tuple(a for a in live if a.spec.kind in NET_KINDS)
        self.disk = disk or None
        self.net = net or None

    # -- decisions -----------------------------------------------------------

    def _decide(self, a: _Armed, target_key: str) -> bool:
        """Roll the fault's schedule for one matching call; on fire, burn
        budget, bump counters, and tag the active trace span."""
        with self._lock:
            if a.remaining == 0:
                return False
            if a.spec.probability < 1.0 and a.rng.random() >= a.spec.probability:
                return False
            if a.remaining > 0:
                a.remaining -= 1
                if a.remaining == 0:
                    self._refresh()
            a.injected += 1
            key = (a.spec.kind, a.spec.target or "*")
            self._injected[key] = self._injected.get(key, 0) + 1
        cur = tracing.current()
        if cur is not None:
            set_fn = getattr(cur, "set", None)  # _RemoteParent has no tags
            if set_fn is not None:
                set_fn(chaos_kind=a.spec.kind, chaos_target=target_key)
        return True

    def match_disk(self, endpoint: str, op: str, volume: str = "", path: str = ""):
        """First armed disk fault firing for this StorageAPI call, or None."""
        snap = self.disk
        if snap is None:
            return None
        where = f"{volume}/{path}" if path else volume
        for a in snap:
            spec = a.spec
            if spec.target and spec.target not in endpoint:
                continue
            if spec.ops and op not in spec.ops:
                continue
            if spec.path and not where.startswith(spec.path):
                continue
            if self._decide(a, f"{endpoint}:{op}"):
                return spec
        return None

    def match_net(self, url: str, path: str = ""):
        """First armed net fault firing for this RPC, or None."""
        snap = self.net
        if snap is None:
            return None
        full = url + path
        for a in snap:
            spec = a.spec
            if spec.kind == LOCK_DEATH and _LOCK_PATH_MARKER not in url:
                continue
            if spec.target and spec.target not in full:
                continue
            if spec.ops and path not in spec.ops:
                continue
            if self._decide(a, full):
                return spec
        return None


# Process-global registry (the GLOBAL_TRACE / GLOBAL_METRICS pattern): the
# admin chaos API arms it on every node via peer fanout; wrappers and the
# RestClient hook consult it. Tests that want isolation construct their own.
REGISTRY = FaultRegistry()
