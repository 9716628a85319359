"""Pool lifecycle: attach-pool expansion, checkpointed decommission, status.

Role of the reference's pool lifecycle machinery (cmd/erasure-server-pool-
decom.go + cmd/erasure-server-pool-mgmt.go): the ServerPools list stops
being a boot-time constant and becomes a managed set. Three operations:

  * attach   -- a new pool joins a running cluster. Two-phase: the pool is
                added SUSPENDED, the bumped pool-config epoch is persisted
                and fanned out to every peer (dist/peer.py `poolsreload`),
                and only once the cluster agrees on the pool set is the
                pool flipped ACTIVE so new writes may land on it.
  * drain    -- decommission: walk the pool's namespace through the
                metacache resume-cursor discipline, re-PUT every version
                into the remaining pools with the existing erasure PUT
                path, delete the source copy, checkpoint the (bucket,
                object) cursor like control/healmgr.HealingTracker so a
                crash or node kill RESUMES instead of restarting.
  * status   -- per-pool capacity/used/objects + drain progress, served by
                GET /mtpu/admin/v1/pools/status and the minio_tpu_pool_*
                gauges in control/metrics.py.

Pool statuses live on ServerPools (object/pools.py) so placement decisions
never need this module; the manager owns transitions, persistence (the
pool-config epoch + drain trackers are journaled into SYS_DIR on every
pool's set-0 drives, storage/recovery.py-style: readable after any single
pool is lost), and the background drain/rebalance threads.

A copy of the JAX package's object/poolmgr.py: the persisted pool config
(`pools/config.json`) and the decommission checkpoints (`pools/drain-<i>.json`)
are the same bytes, so a JAX node resumes a drain a port node checkpointed,
and the other way round.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass

from ..control.perf import GLOBAL_PERF
from ..control.sanitizer import san_lock
from ..storage.format import SYS_DIR
from ..storage.xlmeta import XLMeta
from ..utils import errors
from . import metadata as meta_mod
from .pools import (
    POOL_ACTIVE,
    POOL_DECOMMISSIONED,
    POOL_DRAINING,
    POOL_SUSPENDED,
    ServerPools,
)

log = logging.getLogger("minio_tpu_torch.pool")

CONFIG_FILE = "pools/config.json"
DRAIN_FILE = "pools/drain-{}.json"

# Verification passes after the namespace first reads empty: in-flight
# multipart commits and racing PUTs that slipped into the draining pool
# behind the walk are re-swept, bounded so a write loop cannot pin the
# drain forever (the reference re-lists after decom for the same reason).
MAX_DRAIN_ROUNDS = 5

_GAUGE_TTL_S = 5.0  # per-pool data walk cache for /metrics + /pools/status


class PoolLifecycleStats:
    """Process-wide pool-lifecycle counters, rendered as minio_tpu_pool_*
    in control/metrics.py (the mtpulint metrics-rendered rule holds every
    counter bumped here to that exposition)."""

    def __init__(self):
        self._lock = san_lock("PoolLifecycleStats._lock")
        self.pools_attached = 0
        self.epoch_bumps = 0
        self.decommissions_started = 0
        self.decommissions_resumed = 0
        self.decommissions_completed = 0
        self.objects_moved = 0
        self.bytes_moved = 0
        self.move_failures = 0
        self.checkpoints = 0
        self.rebalance_rounds = 0

    def note_attach(self) -> None:
        with self._lock:
            self.pools_attached += 1

    def note_epoch(self) -> None:
        with self._lock:
            self.epoch_bumps += 1

    def note_decommission(self, event: str) -> None:
        with self._lock:
            if event == "started":
                self.decommissions_started += 1
            elif event == "resumed":
                self.decommissions_resumed += 1
            elif event == "completed":
                self.decommissions_completed += 1

    def note_move(self, nbytes: int) -> None:
        with self._lock:
            self.objects_moved += 1
            self.bytes_moved += nbytes

    def note_move_failure(self) -> None:
        with self._lock:
            self.move_failures += 1

    def note_checkpoint(self) -> None:
        with self._lock:
            self.checkpoints += 1

    def note_rebalance_round(self) -> None:
        with self._lock:
            self.rebalance_rounds += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                k: v for k, v in self.__dict__.items() if not k.startswith("_")
            }


STATS = PoolLifecycleStats()


@dataclass
class DecommissionTracker:
    """Drain progress journaled to the surviving pools' drives (the
    HealingTracker discipline of control/healmgr.py, persisted OFF the
    dying pool): a node killed mid-drain resumes from the last
    checkpointed (bucket, object) cursor instead of re-walking."""

    pool_index: int = 0
    started: float = 0.0
    last_update: float = 0.0
    finished: bool = False
    failed: str = ""
    objects_moved: int = 0
    objects_failed: int = 0
    bytes_moved: int = 0
    checkpoints: int = 0
    # Resume cursor: buckets and objects walk in sorted order; restart
    # skips buckets < resume_bucket and, within it, names <= resume_object.
    resume_bucket: str = ""
    resume_object: str = ""

    def save(self, pools: ServerPools) -> None:
        self.last_update = time.time()
        _write_sys(
            pools,
            DRAIN_FILE.format(self.pool_index),
            json.dumps(asdict(self)).encode(),
            exclude=self.pool_index,
        )

    @staticmethod
    def load(pools: ServerPools, pool_index: int) -> "DecommissionTracker | None":
        raw = _read_sys(pools, DRAIN_FILE.format(pool_index))
        if raw is None:
            return None
        try:
            return DecommissionTracker(**json.loads(raw.decode()))
        except (ValueError, TypeError):
            return None


def _sys_drives(pools: ServerPools, exclude: int = -1, per_pool: int = 2):
    """First N online set-0 drives of every pool (minus `exclude`): the
    replica set the pool config + drain journals are written to. Reads scan
    the same drives, so the journal survives losing any one pool."""
    for pi, p in enumerate(pools.pools):
        if pi == exclude or not p.sets:
            continue
        n = 0
        for d in p.sets[0].disks:
            if d is None or not d.is_online():
                continue
            yield d
            n += 1
            if n >= per_pool:
                break


def _write_sys(pools: ServerPools, path: str, blob: bytes, exclude: int = -1) -> None:
    for d in _sys_drives(pools, exclude=exclude):
        try:
            d.write_all(SYS_DIR, path, blob)
        except errors.StorageError:
            continue


def _read_sys(pools: ServerPools, path: str) -> bytes | None:
    for d in _sys_drives(pools):
        try:
            return d.read_all(SYS_DIR, path)
        except errors.StorageError:
            continue
    return None


class PoolManager:
    """Owns pool statuses, the pool-config epoch, attach/decommission
    transitions, and the drain/rebalance worker threads. One per node
    (dist/node.py builds it right after the peer NotificationSys); a bare
    ServerPools works too (unit tests) -- attach-by-endpoints and fanout
    are then unavailable, everything else behaves."""

    def __init__(self, pools: ServerPools, notification=None, node=None):
        self.pools = pools
        self.notification = notification
        self.node = node
        self.epoch = 0
        self._lock = san_lock("PoolManager._lock")
        self._drain_threads: dict[int, threading.Thread] = {}
        self._drain_stops: dict[int, threading.Event] = {}
        self.trackers: dict[int, DecommissionTracker] = {}
        self._gauge_cache: dict[int, tuple[float, int, int]] = {}
        from ..control.rebalance import RebalanceEngine

        self.rebalancer = RebalanceEngine(pools, stats=STATS)
        # Raw endpoint specs per pool index (None for boot pools built from
        # an endpoint list the node already knows, or pools with no node).
        self._endpoints: dict[int, list[str]] = {}

    # -- config persistence ---------------------------------------------------

    def _persist(self) -> None:
        doc = {
            "epoch": self.epoch,
            "pools": [
                {
                    "endpoints": self._endpoints.get(i),
                    "status": self.pools.statuses[i],
                }
                for i in range(len(self.pools.pools))
            ],
        }
        _write_sys(self.pools, CONFIG_FILE, json.dumps(doc).encode())

    def _bump_epoch_and_fanout(self) -> None:
        """Persist the new pool config under a bumped epoch, then tell every
        peer to reload it. Callers mutate statuses BEFORE calling this, so
        by the time the fanout returns, all reachable nodes agree."""
        self.epoch += 1
        STATS.note_epoch()
        self._persist()
        if self.notification is not None:
            self.notification.pools_reload_all()

    def load_config(self) -> bool:
        """Apply the persisted pool config if its epoch is newer than ours:
        statuses by index, and (when a node callback is available) attach
        any pool this process has not built yet. Returns True if applied."""
        raw = _read_sys(self.pools, CONFIG_FILE)
        if raw is None:
            return False
        try:
            doc = json.loads(raw.decode())
        except ValueError:
            return False
        epoch = int(doc.get("epoch", 0))
        if epoch <= self.epoch:
            return False
        entries = doc.get("pools", [])
        for i, ent in enumerate(entries):
            if i >= len(self.pools.pools):
                eps = ent.get("endpoints")
                if self.node is None or not eps:
                    log.warning(
                        "pool %d in persisted config has no buildable "
                        "endpoints on this node; skipped", i,
                    )
                    continue
                try:
                    sets = self.node.build_pool_from_endpoints(eps)
                except errors.StorageError as e:
                    log.error("cannot build persisted pool %d: %s", i, e)
                    continue
                self._replicate_buckets(sets)
                self.pools.add_pool(sets, status=ent.get("status", POOL_SUSPENDED))
                self._endpoints[i] = list(eps)
                if hasattr(self.node, "_wire_new_pool"):
                    self.node._wire_new_pool(sets)
            else:
                if ent.get("endpoints"):
                    self._endpoints[i] = list(ent["endpoints"])
                self.pools.set_pool_status(i, ent.get("status", POOL_ACTIVE))
        self.epoch = epoch
        return True

    def resume_pending(self) -> list[int]:
        """Restart the drain of every pool the persisted config left in
        DRAINING (the crash/kill recovery path): the tracker's checkpointed
        cursor picks up where the dead process stopped."""
        resumed = []
        for i, st in enumerate(self.pools.statuses):
            if st != POOL_DRAINING or i in self._drain_threads:
                continue
            tracker = DecommissionTracker.load(self.pools, i)
            if tracker is None or tracker.finished:
                tracker = DecommissionTracker(pool_index=i, started=time.time())
            tracker.failed = ""  # fresh attempt; the crash note served its turn
            STATS.note_decommission("resumed")
            self._spawn_drain(i, tracker)
            resumed.append(i)
        return resumed

    # -- attach ---------------------------------------------------------------

    def attach(self, sets, endpoints: list[str] | None = None) -> int:
        """Attach an already-built ErasureSets as a new pool. Two-phase so
        no node routes a write to the pool before the whole cluster knows
        it exists: SUSPENDED + epoch fanout first, ACTIVE + epoch fanout
        second."""
        from ..control import tracing

        with tracing.span("attach", "pool", pools=len(self.pools.pools) + 1):
            with self._lock:
                self._replicate_buckets(sets)
                idx = self.pools.add_pool(sets, status=POOL_SUSPENDED)
                if endpoints:
                    self._endpoints[idx] = list(endpoints)
                self._bump_epoch_and_fanout()
                # Every peer now agrees pool `idx` exists (suspended):
                # flipping it ACTIVE cannot race a write from a node that
                # would route it to a pool set without the newcomer.
                self.pools.set_pool_status(idx, POOL_ACTIVE)
                self._bump_epoch_and_fanout()
            STATS.note_attach()
        return idx

    def _replicate_buckets(self, sets) -> None:
        """Existing buckets must exist on a joining pool before any write
        can be placed there (the reference heals buckets into new pools)."""
        try:
            buckets = self.pools.list_buckets()
        except errors.StorageError:
            return
        for bi in buckets:
            try:
                sets.make_bucket(bi.name)
            except (errors.ObjectError, errors.StorageError):
                continue

    def attach_endpoints(self, endpoints: list[str]) -> int:
        """Attach a pool from raw endpoint specs (the admin POST body).
        Needs the node: drive construction is an endpoint concern."""
        if self.node is None:
            raise errors.InvalidArgument(
                "", "", "attach by endpoints needs a running node"
            )
        return self.node.attach_pool(endpoints)

    # -- decommission ----------------------------------------------------------

    def start_decommission(
        self, pool_index: int, wait: bool = False,
        checkpoint_every: int | None = None,
    ) -> DecommissionTracker:
        with self._lock:
            if not 0 <= pool_index < len(self.pools.pools):
                raise errors.InvalidArgument("", "", f"no pool {pool_index}")
            active = [
                i for i, st in enumerate(self.pools.statuses)
                if st == POOL_ACTIVE and i != pool_index
            ]
            if not active:
                raise errors.InvalidArgument(
                    "", "", "cannot drain the last active pool"
                )
            st = self.pools.statuses[pool_index]
            if st == POOL_DRAINING:
                raise errors.InvalidArgument("", "", f"pool {pool_index} already draining")
            if st == POOL_DECOMMISSIONED:
                raise errors.InvalidArgument("", "", f"pool {pool_index} already decommissioned")
            self.pools.set_pool_status(pool_index, POOL_DRAINING)
            self._bump_epoch_and_fanout()
            tracker = DecommissionTracker(pool_index=pool_index, started=time.time())
            if checkpoint_every is not None:
                self._checkpoint_every = checkpoint_every
            tracker.save(self.pools)
            STATS.note_decommission("started")
            t = self._spawn_drain(pool_index, tracker, checkpoint_every)
        if wait:
            t.join()
        return tracker

    def _spawn_drain(
        self, pool_index: int, tracker: DecommissionTracker,
        checkpoint_every: int | None = None,
    ) -> threading.Thread:
        stop = threading.Event()
        self._drain_stops[pool_index] = stop
        self.trackers[pool_index] = tracker

        def run():
            try:
                self._drain(pool_index, tracker, stop, checkpoint_every)
            except Exception as e:  # noqa: BLE001 - drain thread must not die silently
                tracker.failed = f"{type(e).__name__}: {e}"[:300]
                try:
                    tracker.save(self.pools)
                except errors.StorageError:
                    pass
                log.error("drain of pool %d failed: %s", pool_index, e)

        t = threading.Thread(
            target=run, daemon=True, name=f"pool-drain-{pool_index}"
        )
        self._drain_threads[pool_index] = t
        t.start()
        return t

    def _pool_buckets(self, pool) -> list[str]:
        """Every volume present on the pool's drives -- INCLUDING system
        buckets: config-store objects living on a drained pool must move
        with everything else or a restart loses them. Raw non-object files
        (format.json, journals, metacache images) are invisible to the
        object walk and stay put; the drained pool keeps its volumes."""
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

    @staticmethod
    def _iter_entries(pool, bucket: str, marker: str):
        """Error-tolerant namespace walk: volumes that hold only raw files
        (persisted metacache images, journals) fail the object walk with
        BucketNotFound on most drives -- skip them, they carry no objects."""
        try:
            yield from pool.metacache.entries_from(bucket, "", marker)
        except errors.StorageError as e:
            log.debug("walk of %s skipped: %s", bucket, e)

    def _drain(
        self, pool_index: int, tracker: DecommissionTracker,
        stop: threading.Event, checkpoint_every: int | None = None,
    ) -> None:
        """The decommission state machine body: DRAINING -> (walk + move +
        checkpoint)* -> verify-empty -> DECOMMISSIONED. Runs on the drain
        thread; also callable synchronously (tests inject crashes here)."""
        from ..control.rebalance import ObjectMover, ThrottleBudget

        pool = self.pools.pools[pool_index]
        every = checkpoint_every or int(os.environ.get("MTPU_DECOM_CHECKPOINT", "64"))
        workers = max(1, int(os.environ.get("MTPU_DECOM_WORKERS", "4")))
        mover = ObjectMover(self.pools, ThrottleBudget(), stats=STATS)
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            for _round in range(MAX_DRAIN_ROUNDS):
                for bucket in self._pool_buckets(pool):
                    if bucket < tracker.resume_bucket:
                        continue
                    marker = (
                        tracker.resume_object
                        if bucket == tracker.resume_bucket else ""
                    )
                    batch: list[tuple[str, bytes]] = []
                    for name, raw in self._iter_entries(pool, bucket, marker):
                        if stop.is_set():
                            tracker.save(self.pools)
                            return
                        batch.append((name, raw))
                        if len(batch) >= workers:
                            self._move_batch(
                                pool_index, bucket, batch, mover, tracker, every
                            )
                            batch = []
                    if batch:
                        self._move_batch(
                            pool_index, bucket, batch, mover, tracker, every
                        )
                    # Past-the-end marker: resume skips the whole bucket.
                    tracker.resume_bucket, tracker.resume_object = bucket, "￿"
                if self._pool_object_count(pool) == 0:
                    break
                # Writers raced the walk (multipart commits in flight when
                # the drain started): rescan from the top.
                tracker.resume_bucket = tracker.resume_object = ""
                tracker.save(self.pools)
            else:
                raise errors.StorageError(
                    f"pool {pool_index} still non-empty after "
                    f"{MAX_DRAIN_ROUNDS} drain rounds"
                )
            with self._lock:
                self.pools.set_pool_status(pool_index, POOL_DECOMMISSIONED)
                self._bump_epoch_and_fanout()
            tracker.finished = True
            tracker.save(self.pools)
            STATS.note_decommission("completed")
            log.info(
                "pool %d decommissioned: %d objects / %d bytes moved "
                "(%d failed)", pool_index, tracker.objects_moved,
                tracker.bytes_moved, tracker.objects_failed,
            )
        finally:
            GLOBAL_PERF.ledger.record(
                "pool", "drain",
                time.perf_counter() - t0, time.thread_time() - c0,
            )

    def _move_batch(
        self, pool_index: int, bucket: str, batch: list,
        mover, tracker: DecommissionTracker, every: int,
    ) -> None:
        src = self.pools.pools[pool_index]

        def one(item):
            name, raw = item
            dst = self._placement_pool(exclude=pool_index)
            return mover.move(src, dst, bucket, name, raw)

        for (res, err), (name, _raw) in zip(
            meta_mod.parallel_map(one, batch), batch
        ):
            if err is not None:
                tracker.objects_failed += 1
                STATS.note_move_failure()
                log.warning("drain move %s/%s failed: %s", bucket, name, err)
            else:
                tracker.objects_moved += 1
                tracker.bytes_moved += int(res or 0)
        tracker.resume_bucket = bucket
        tracker.resume_object = batch[-1][0]
        if tracker.objects_moved // every != (
            tracker.objects_moved - len(batch)
        ) // every:
            tracker.checkpoints += 1
            tracker.save(self.pools)
            STATS.note_checkpoint()
        hook = getattr(self, "_drain_hook", None)
        if hook is not None:
            hook(tracker)

    def _placement_pool(self, exclude: int):
        """Most-free ACTIVE pool other than `exclude` (deterministic, the
        same (free, index) order _pool_with_space uses)."""
        best = None
        best_key = None
        for i, p in enumerate(self.pools.pools):
            if i == exclude or self.pools.statuses[i] != POOL_ACTIVE:
                continue
            free = 0
            for d in p.disks:
                if d is None:
                    continue
                try:
                    free += d.disk_info().free
                except errors.DiskError:
                    continue
            key = (-free, i)
            if best_key is None or key < best_key:
                best, best_key = p, key
        if best is None:
            raise errors.StorageError("no active pool to drain into")
        return best

    # -- rebalance -------------------------------------------------------------

    def start_rebalance(self, threshold: float | None = None) -> dict:
        self.rebalancer.start(threshold=threshold)
        return self.rebalancer.status()

    def stop_rebalance(self) -> dict:
        self.rebalancer.stop()
        return self.rebalancer.status()

    # -- status / gauges -------------------------------------------------------

    def _pool_object_count(self, pool) -> int:
        n = 0
        for bucket in self._pool_buckets(pool):
            for _name, _raw in self._iter_entries(pool, bucket, ""):
                n += 1
        return n

    def pool_gauges(self, pool_index: int) -> dict:
        """capacity/free from disk_info; objects/data bytes from a merged
        namespace walk, TTL-cached so /metrics scrapes stay cheap."""
        pool = self.pools.pools[pool_index]
        total = free = 0
        for d in pool.disks:
            if d is None:
                continue
            try:
                di = d.disk_info()
                total += di.total
                free += di.free
            except errors.DiskError:
                continue
        now = time.monotonic()
        cached = self._gauge_cache.get(pool_index)
        if cached is not None and now - cached[0] < _GAUGE_TTL_S:
            objects, data_bytes = cached[1], cached[2]
        else:
            objects = data_bytes = 0
            for bucket in self._pool_buckets(pool):
                try:
                    for _name, raw in pool.metacache.entries_from(bucket, "", ""):
                        objects += 1
                        try:
                            meta = XLMeta.from_bytes(raw)
                        except errors.StorageError:
                            continue
                        data_bytes += sum(
                            v.size for v in meta.versions if not v.deleted
                        )
                except errors.StorageError:
                    continue
            self._gauge_cache[pool_index] = (now, objects, data_bytes)
        return {
            "index": pool_index,
            "status": self.pools.statuses[pool_index],
            "capacity_bytes": total,
            "free_bytes": free,
            "data_bytes": data_bytes,
            "objects": objects,
        }

    def status(self) -> dict:
        out = {
            "epoch": self.epoch,
            "stats": STATS.snapshot(),
            "rebalance": self.rebalancer.status(),
            "pools": [],
        }
        for i in range(len(self.pools.pools)):
            row = self.pool_gauges(i)
            # Freshest of the in-memory tracker and the journal: after a
            # local kill another node may have resumed the drain, and its
            # checkpoints land in the journal, not in this process.
            mem = self.trackers.get(i)
            disk = DecommissionTracker.load(self.pools, i)
            tracker = mem
            if disk is not None and (
                mem is None or disk.last_update >= mem.last_update
            ):
                tracker = disk
            if tracker is not None:
                row["drain"] = asdict(tracker)
            out["pools"].append(row)
        return out

    # -- lifecycle -------------------------------------------------------------

    def join(self, timeout: float = 60.0) -> None:
        """Wait out running drains (tests + decommission --wait)."""
        for t in list(self._drain_threads.values()):
            t.join(timeout)
        self.rebalancer.join(timeout)

    def stop(self) -> None:
        """Stop drain + rebalance workers; drains checkpoint their cursor
        on the way out so a later resume_pending continues, not restarts."""
        for ev in self._drain_stops.values():
            ev.set()
        self.rebalancer.stop()
        for t in self._drain_threads.values():
            t.join(10.0)
