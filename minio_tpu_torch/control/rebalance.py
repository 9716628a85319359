"""Throttled cross-pool object migration: the move engine under both
decommission and rebalance-on-expansion.

Role of the reference's erasure-server-pool-rebalance.go: after an
attach-pool expansion the old pools sit above average utilization and the
new pool is empty; this engine moves objects out of >avg-utilization pools
into the under-utilized ones until the utilization skew drops below a
threshold. The same primitive -- read every version from the source pool,
re-PUT it into the destination with the existing erasure PUT path, delete
the source copy -- also serves object/poolmgr.py's decommission drain; the
two differ only in the walk (drain walks one pool to empty, rebalance walks
the fattest pool until skew converges).

Every byte moved passes a ThrottleBudget (ops/s + bytes/s leaky bucket, env
MTPU_REBALANCE_OPS_PER_S / MTPU_REBALANCE_BYTES_PER_S): the bulk re-PUT
traffic a drain generates is exactly the repair-bandwidth problem the
regenerating-codes literature attacks, and until the codec can ship
sub-object repair symbols the defense is pacing, so live traffic keeps its
SLO while migration saturates the leftover budget.

A copy of the JAX package's control/rebalance.py. Every version it moves is
read with its bitrot verify and written again with its encode through the
codec the pools' sets hold: on the card, the batching device codec's CUDA
kernels. A mover built before any codec is installed raises, as every other
entry point does (`require_codec`).
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ..object.types import GetObjectOptions, PutObjectOptions
from ..storage.xlmeta import XLMeta
from ..utils import errors
from .perf import GLOBAL_PERF
from .sanitizer import san_lock

log = logging.getLogger("minio_tpu_torch.rebalance")

# Live budgets, so control/metrics.py can sum throttle_waits /
# throttled_seconds across every migration in flight.
_budgets_lock = san_lock("rebalance._budgets_lock")
_live_budgets: list["ThrottleBudget"] = []


def budget_totals() -> tuple[int, float]:
    with _budgets_lock:
        waits = sum(b.throttle_waits for b in _live_budgets)
        secs = sum(b.throttled_seconds for b in _live_budgets)
    return waits, secs


def require_codec(pools) -> None:
    """Resolve the codec of every pool's sets: a set built without one takes
    the process default, which raises on "cuda" without a card. No path of
    this module or the scanner moves or heals an object on any other codec."""
    for p in pools.pools:
        for s in p.sets:
            s.codec  # noqa: B018 - resolving the codec is the check


class ThrottleBudget:
    """Leaky-bucket pacing for migration traffic (GCRA: one virtual clock,
    each move pushes it forward by its cost; the mover sleeps whenever the
    clock runs ahead of real time). 0 / unset = unlimited."""

    def __init__(
        self,
        bytes_per_s: float | None = None,
        ops_per_s: float | None = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        if bytes_per_s is None:
            bytes_per_s = float(os.environ.get("MTPU_REBALANCE_BYTES_PER_S", "0"))
        if ops_per_s is None:
            ops_per_s = float(os.environ.get("MTPU_REBALANCE_OPS_PER_S", "0"))
        self.bytes_per_s = bytes_per_s
        self.ops_per_s = ops_per_s
        self._clock = clock
        self._sleep = sleep
        self._lock = san_lock("ThrottleBudget._lock")
        self._next_free = 0.0
        self.ops = 0
        self.bytes = 0
        self.throttle_waits = 0
        self.throttled_seconds = 0.0
        with _budgets_lock:
            _live_budgets.append(self)

    def consume(self, nbytes: int, ops: int = 1) -> float:
        """Charge one move of `nbytes`; sleep if over budget. Returns the
        wait applied (0.0 when under budget)."""
        cost = 0.0
        if self.bytes_per_s > 0:
            cost += nbytes / self.bytes_per_s
        if self.ops_per_s > 0:
            cost += ops / self.ops_per_s
        with self._lock:
            self.ops += ops
            self.bytes += nbytes
            now = self._clock()
            self._next_free = max(self._next_free, now)
            wait = self._next_free - now
            self._next_free += cost
            if wait > 0:
                self.throttle_waits += 1
                self.throttled_seconds += wait
        if wait > 0:
            self._sleep(wait)
        return wait


class ObjectMover:
    """Move one object -- every version, oldest first -- from a source pool
    to a destination pool through the ordinary erasure read/PUT path, then
    delete it from the source. The unit of work both drain and rebalance
    schedule."""

    def __init__(self, pools, budget: ThrottleBudget, stats=None):
        require_codec(pools)
        self.pools = pools
        self.budget = budget
        self.stats = stats

    def move(self, src, dst, bucket: str, name: str, raw: bytes) -> int:
        """Returns bytes moved. `raw` is the merged xl.meta blob the
        metacache walk yielded for this name."""
        t0 = time.perf_counter()
        c0 = time.thread_time()
        moved = 0
        try:
            meta = XLMeta.from_bytes(raw)
            # Oldest first so dst ends with the same latest-version order.
            for fi in sorted(meta.versions, key=lambda v: v.mod_time):
                if fi.deleted:
                    # Recreate the delete marker on dst. Simplification vs
                    # the reference (which transplants marker version ids):
                    # the marker is re-minted, history depth survives but
                    # marker ids change.
                    from ..object.types import DeleteObjectOptions

                    try:
                        dst.delete_object(
                            bucket, name, DeleteObjectOptions(versioned=True)
                        )
                    except errors.ObjectError:
                        pass
                    continue
                try:
                    oi, data = src.get_object(
                        bucket, name, GetObjectOptions(version_id=fi.version_id)
                    )
                except (errors.ObjectNotFound, errors.VersionNotFound):
                    continue  # deleted under us / already moved: idempotent
                if not fi.version_id:
                    # Unversioned object: a client PUT that landed on dst
                    # after the walk snapshot must not be clobbered by this
                    # older copy.
                    try:
                        cur = dst.get_object_info(bucket, name)
                        if cur.mod_time >= oi.mod_time:
                            continue
                    except errors.ObjectError:
                        pass
                self.budget.consume(len(data))
                dst.put_object(
                    bucket,
                    name,
                    data,
                    PutObjectOptions(
                        user_defined=dict(oi.user_defined),
                        versioned=bool(fi.version_id),
                        version_id=fi.version_id,
                        content_type=oi.content_type or "application/octet-stream",
                        etag=oi.etag,
                    ),
                )
                moved += len(data)
                if self.stats is not None:
                    self.stats.note_move(len(data))
            self._delete_source(src, bucket, name, meta)
            return moved
        finally:
            GLOBAL_PERF.ledger.record(
                "pool", "move-object",
                time.perf_counter() - t0, time.thread_time() - c0,
            )

    def _delete_source(self, src, bucket: str, name: str, meta: XLMeta) -> None:
        from ..object.types import DeleteObjectOptions

        for fi in meta.versions:
            try:
                src.delete_object(
                    bucket, name,
                    DeleteObjectOptions(version_id=fi.version_id or ""),
                )
            except errors.ObjectError:
                continue
        # Unversioned leftovers (version_id "") fall through the loop above
        # already; a final unqualified delete catches a version the walk
        # snapshot missed.
        try:
            src.delete_object(bucket, name, DeleteObjectOptions())
        except errors.ObjectError:
            pass


class RebalanceEngine:
    """Background rebalance-on-expansion: measure per-pool utilization skew
    (data bytes as a share of capacity), move objects from the max-skew
    donor into the min-skew recipient, repeat until skew < threshold."""

    def __init__(self, pools, stats=None):
        self.pools = pools
        self.stats = stats
        self._lock = san_lock("RebalanceEngine._lock")
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.running = False
        self.last_skew = 0.0
        self.rounds = 0
        self.objects_moved = 0
        self.bytes_moved = 0
        self.batch_size = 16

    # -- measurement ----------------------------------------------------------

    def _pool_usage(self, pi: int) -> tuple[int, int]:
        """(capacity_bytes, data_bytes) for pool pi: capacity from
        disk_info, data from a namespace walk (in-process pools share one
        filesystem, so statvfs 'used' can't tell pools apart)."""
        pool = self.pools.pools[pi]
        cap = 0
        for d in pool.disks:
            if d is None:
                continue
            try:
                cap += d.disk_info().total
            except errors.DiskError:
                continue
        data = 0
        for bucket in self._buckets(pool):
            try:
                for _name, raw in pool.metacache.entries_from(bucket, "", ""):
                    try:
                        meta = XLMeta.from_bytes(raw)
                    except errors.StorageError:
                        continue
                    data += sum(v.size for v in meta.versions if not v.deleted)
            except errors.StorageError:
                continue
        return cap, data

    @staticmethod
    def _buckets(pool) -> list[str]:
        names: set[str] = set()
        for s in pool.sets:
            for d in s.disks:
                if d is None:
                    continue
                try:
                    names.update(v.name for v in d.list_vols())
                except errors.StorageError:
                    continue
        return sorted(names)

    def _skews(self) -> dict[int, float]:
        """Per-active-pool skew: data share minus capacity share. Positive
        = over-utilized donor, negative = under-utilized recipient."""
        from ..object.pools import POOL_ACTIVE

        usage = {}
        for i in range(len(self.pools.pools)):
            if self.pools.statuses[i] != POOL_ACTIVE:
                continue
            usage[i] = self._pool_usage(i)
        total_cap = sum(c for c, _ in usage.values()) or 1
        total_data = sum(d for _, d in usage.values())
        if total_data == 0:
            return {i: 0.0 for i in usage}
        return {
            i: d / total_data - c / total_cap for i, (c, d) in usage.items()
        }

    # -- control --------------------------------------------------------------

    def start(self, threshold: float | None = None) -> None:
        if threshold is None:
            threshold = float(os.environ.get("MTPU_REBALANCE_SKEW", "0.10"))
        with self._lock:
            if self.running:
                return
            self._stop.clear()
            self.running = True
            self._thread = threading.Thread(
                target=self._run, args=(threshold,),
                daemon=True, name="pool-rebalance",
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(10.0)
        with self._lock:
            self.running = False

    def join(self, timeout: float = 60.0) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def status(self) -> dict:
        waits, secs = budget_totals()
        return {
            "running": self.running,
            "rounds": self.rounds,
            "last_skew": self.last_skew,
            "objects_moved": self.objects_moved,
            "bytes_moved": self.bytes_moved,
            "throttle_waits": waits,
            "throttled_seconds": secs,
        }

    # -- worker ---------------------------------------------------------------

    def _run(self, threshold: float) -> None:
        try:
            while not self._stop.is_set():
                moved = self._round(threshold)
                if moved == 0:
                    break
        finally:
            with self._lock:
                self.running = False

    def _round(self, threshold: float) -> int:
        """One rebalance round: pick donor + recipient by skew, move a
        batch. Returns objects moved (0 = converged / nothing to do)."""
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            from ..object.pools import POOL_ACTIVE

            usage = {
                i: self._pool_usage(i)
                for i in range(len(self.pools.pools))
                if self.pools.statuses[i] == POOL_ACTIVE
            }
            if len(usage) < 2:
                return 0
            total_cap = sum(c for c, _ in usage.values()) or 1
            total_data = sum(d for _, d in usage.values())
            if total_data == 0:
                self.last_skew = 0.0
                return 0
            skews = {
                i: d / total_data - c / total_cap for i, (c, d) in usage.items()
            }
            self.last_skew = max(skews.values())
            if self.last_skew <= threshold:
                return 0
            donor = max(skews, key=lambda i: skews[i])
            recipient = min(skews, key=lambda i: skews[i])
            if donor == recipient:
                return 0
            # Bytes the donor holds above its fair (capacity-proportional)
            # share: the round's ceiling. Moving a fixed batch instead
            # would overshoot on small namespaces and ping-pong objects
            # between pools forever.
            excess = usage[donor][1] - usage[donor][0] / total_cap * total_data
            src = self.pools.pools[donor]
            dst = self.pools.pools[recipient]
            mover = ObjectMover(self.pools, ThrottleBudget(), stats=self.stats)
            moved = 0
            moved_bytes = 0

            def done() -> bool:
                return (
                    self._stop.is_set()
                    or moved >= self.batch_size
                    or moved_bytes >= excess
                )

            for bucket in self._buckets(src):
                try:
                    entries = list(src.metacache.entries_from(bucket, "", ""))
                except errors.StorageError:
                    # Raw-file volumes (metacache images, journals) fail the
                    # quorum object walk; they carry no objects to move.
                    continue
                for name, raw in entries:
                    if done():
                        break
                    try:
                        nbytes = mover.move(src, dst, bucket, name, raw)
                    except errors.StorageError as e:
                        log.warning(
                            "rebalance move %s/%s failed: %s", bucket, name, e
                        )
                        continue
                    moved += 1
                    moved_bytes += nbytes
                if done():
                    break
            with self._lock:
                self.rounds += 1
                self.objects_moved += moved
                self.bytes_moved += moved_bytes
            if self.stats is not None:
                self.stats.note_rebalance_round()
            return moved
        finally:
            GLOBAL_PERF.ledger.record(
                "pool", "rebalance-round",
                time.perf_counter() - t0, time.thread_time() - c0,
            )
