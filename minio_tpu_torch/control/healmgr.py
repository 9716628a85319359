"""Background healing: MRF queue, heal sequences, new-disk monitor.

Role of the reference's heal trio (SURVEY.md section 2.7 Healing):
  * MRFState (cmd/mrf.go): "most recently failed" writes -- puts that
    succeeded at quorum but failed on some drives -- queued for async repair
    (fed from erasure-object.go:1430 addPartial);
  * healSequence (cmd/admin-heal-ops.go:396): admin-triggered namespace
    sweeps with progress state the admin API can poll;
  * new-disk monitor (cmd/background-newdisks-heal-ops.go:314): detects
    drives that came back empty/unformatted and re-protects their data.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field

from ..storage.format import SYS_DIR
from ..utils import errors
from .sanitizer import san_lock

HEALING_FILE = "healing.bin"

log = logging.getLogger("minio_tpu_torch.heal")


@dataclass
class MRFEntry:
    bucket: str
    object_name: str
    version_id: str = ""
    queued: float = field(default_factory=time.time)


class MRFQueue:
    """Async repair queue for partially-failed writes."""

    def __init__(self, layer, maxsize: int = 100_000, start: bool = True):
        self.layer = layer
        self.maxsize = maxsize
        self.q: queue.Queue[MRFEntry] = queue.Queue(maxsize=maxsize)
        self.healed = 0
        self.failed = 0
        self.dropped = 0  # exported as minio_tpu_heal_mrf_dropped_total
        self._overflowing = False
        # Counters are bumped from the worker loop, drain() callers, and
        # add() on request threads concurrently; += is load/add/store.
        self._stats_lock = san_lock("MRFQueue._stats_lock")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="mrf-heal"
            )
            self._thread.start()

    def add(self, bucket: str, object_name: str, version_id: str = "") -> None:
        try:
            self.q.put_nowait(MRFEntry(bucket, object_name, version_id))
        except queue.Full:
            # The scanner sweep will find it later, but a silent drop hides
            # a saturated repair plane: count every one and log once per
            # overflow EPISODE (first drop after a successful enqueue), not
            # once per drop -- a wedged healer would otherwise spam the log.
            with self._stats_lock:
                self.dropped += 1
            if not self._overflowing:
                self._overflowing = True
                log.warning(
                    "MRF queue full (%d entries); dropping heal request for "
                    "%s/%s (scanner sweep will re-find dropped objects)",
                    self.maxsize, bucket, object_name,
                )
        else:
            self._overflowing = False

    def _heal_one(self, entry: MRFEntry) -> None:
        try:
            self.layer.heal_object(entry.bucket, entry.object_name, entry.version_id)
            with self._stats_lock:
                self.healed += 1
        except errors.StorageError:
            with self._stats_lock:
                self.failed += 1

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                entry = self.q.get(timeout=0.5)
            except queue.Empty:
                continue
            if self._stop.is_set():
                # Shutdown raced the dequeue: don't start a heal against a
                # cluster that is tearing down -- dead peers would pin this
                # thread past stop()'s bounded join. The scanner sweep
                # re-finds anything dropped here.
                break
            self._heal_one(entry)

    def join(self, timeout: float = 5.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def drain(self, limit: int | None = None) -> int:
        """Synchronously heal queued entries (tests + shutdown path); returns
        the number of entries processed."""
        n = 0
        while limit is None or n < limit:
            try:
                entry = self.q.get_nowait()
            except queue.Empty:
                break
            self._heal_one(entry)
            n += 1
        return n

    def stop(self) -> None:
        self._stop.set()
        self.join()

    def pending(self) -> int:
        return self.q.qsize()


@dataclass
class HealSequenceStatus:
    seq_id: str
    path: str
    started: float
    finished: float = 0.0
    scanned: int = 0
    healed: int = 0
    failed: int = 0
    running: bool = True


class HealManager:
    """Admin-facing heal sequences + drive monitor."""

    def __init__(self, layer):
        self.layer = layer
        self.sequences: dict[str, HealSequenceStatus] = {}
        self._lock = san_lock("HealManager._lock")
        self._threads: dict[str, threading.Thread] = {}

    # -- heal sequences ------------------------------------------------------

    def start_sequence(self, bucket: str = "", prefix: str = "") -> str:
        seq_id = uuid.uuid4().hex[:12]
        status = HealSequenceStatus(seq_id=seq_id, path=f"{bucket}/{prefix}", started=time.time())
        t = threading.Thread(
            target=self._run_sequence, args=(status, bucket, prefix), daemon=True,
            name=f"heal-seq-{seq_id}",
        )
        with self._lock:
            self.sequences[seq_id] = status
            self._threads[seq_id] = t
        t.start()
        return seq_id

    def join(self, seq_id: str | None = None, timeout: float = 30.0) -> None:
        """Wait out one (or every) heal sequence; finished threads are
        dropped from the registry so it cannot grow unbounded."""
        with self._lock:
            targets = (
                list(self._threads.items())
                if seq_id is None
                else [(seq_id, self._threads[seq_id])]
                if seq_id in self._threads
                else []
            )
        for sid, t in targets:
            t.join(timeout)
            if not t.is_alive():
                with self._lock:
                    self._threads.pop(sid, None)

    def stop(self) -> None:
        self.join()

    def _run_sequence(self, status: HealSequenceStatus, bucket: str, prefix: str) -> None:
        try:
            buckets = (
                [bucket] if bucket else [b.name for b in self.layer.list_buckets()]
            )
            for b in buckets:
                self.layer.heal_bucket(b)
                for pool in self.layer.pools:
                    try:
                        names = [n for n, _ in pool._walk_merged(b, prefix)]
                    except errors.StorageError:
                        continue
                    for name in names:
                        status.scanned += 1
                        try:
                            res = self.layer.heal_object(b, name)
                            if res.disks_healed:
                                status.healed += 1
                        except errors.StorageError:
                            status.failed += 1
        finally:
            status.running = False
            status.finished = time.time()

    def get_status(self, seq_id: str) -> HealSequenceStatus | None:
        with self._lock:
            return self.sequences.get(seq_id)

    # -- drive monitor -------------------------------------------------------

    def check_drives(self) -> list[str]:
        """Drives currently offline or missing format (monitor loop body;
        callers run this periodically)."""
        bad = []
        for pool in self.layer.pools:
            for s in pool.sets:
                for d in s.disks:
                    if d is None:
                        bad.append("<missing>")
                    elif not d.is_online() or not d.disk_id():
                        bad.append(d.endpoint())
        return bad


@dataclass
class HealingTracker:
    """Per-drive heal progress persisted on the drive itself, so a heal of a
    fresh/replaced drive resumes after a restart (the reference's
    healingTracker written to `.healing.bin`,
    cmd/background-newdisks-heal-ops.go:48)."""

    disk_id: str = ""
    endpoint: str = ""
    started: float = 0.0
    last_update: float = 0.0
    finished: bool = False
    objects_scanned: int = 0
    objects_healed: int = 0
    objects_failed: int = 0
    # Resume cursor: the heal walks buckets and objects in sorted order and
    # skips everything <= (resume_bucket, resume_object) on restart.
    resume_bucket: str = ""
    resume_object: str = ""

    def save(self, disk) -> None:
        self.last_update = time.time()
        disk.write_all(SYS_DIR, HEALING_FILE, json.dumps(asdict(self)).encode())

    @staticmethod
    def load(disk) -> "HealingTracker | None":
        try:
            raw = disk.read_all(SYS_DIR, HEALING_FILE)
        except errors.StorageError:
            return None
        try:
            return HealingTracker(**json.loads(raw.decode()))
        except (ValueError, TypeError):
            # Unparseable tracker (e.g. written by another build): the file's
            # presence means a heal is owed — restart it from scratch rather
            # than silently abandoning the drive.
            return HealingTracker(endpoint=disk.endpoint(), started=time.time())

    @staticmethod
    def remove(disk) -> None:
        try:
            disk.delete(SYS_DIR, HEALING_FILE)
        except errors.StorageError:
            pass


def mark_drive_for_healing(disk, disk_id: str = "") -> HealingTracker:
    """Drop a fresh healing tracker on a drive that was just (re)formatted;
    the DiskHealMonitor picks it up (initHealingTracker equivalent)."""
    tr = HealingTracker(
        disk_id=disk_id or disk.disk_id(),
        endpoint=disk.endpoint(),
        started=time.time(),
    )
    tr.save(disk)
    return tr


class DiskHealMonitor:
    """Background loop that heals freshly-replaced drives marked with a
    HealingTracker (monitorLocalDisksAndHeal,
    cmd/background-newdisks-heal-ops.go:314).

    Walks the drive's erasure set in sorted (bucket, object) order, healing
    every version onto the new drive, checkpointing the cursor into the
    tracker every `checkpoint_every` objects."""

    def __init__(self, layer, interval: float = 10.0, checkpoint_every: int = 64,
                 start: bool = True):
        self.layer = layer
        self.interval = interval
        self.checkpoint_every = checkpoint_every
        self.completed: list[HealingTracker] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="disk-heal-monitor"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # The loop re-checks _stop between objects (see _heal_drive), so
            # the join bound is one heal step, not a whole sweep.
            self._thread.join(30.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - monitor must survive anything
                pass
            self._stop.wait(self.interval)

    def tick(self) -> int:
        """One monitor pass; returns number of drives healed to completion."""
        done = 0
        for pool in self.layer.pools:
            for s in pool.sets:
                for d in s.disks:
                    # Local drives only: every node runs a monitor, and each
                    # must sweep only drives it owns or N nodes would race on
                    # the same tracker (monitorLocalDisksAndHeal is local-only
                    # in the reference too).
                    if d is None or not d.is_online() or not d.is_local():
                        continue
                    tr = HealingTracker.load(d)
                    if tr is None:
                        continue
                    if tr.finished:
                        # Completed sweep whose remove() failed earlier.
                        HealingTracker.remove(d)
                        continue
                    self._heal_drive(s, d, tr)
                    if tr.finished:
                        done += 1
        return done

    # -- the per-drive heal sweep -------------------------------------------

    def _iter_set_versions(self, eo, disk, bucket: str):
        """Stream (name, union-of-version-ids) in sorted name order by k-way
        merging the per-drive sorted walks of every online peer — O(drives)
        memory, not O(namespace). The union across peers matters: a
        stale-but-online peer may be missing exactly the versions the fresh
        drive needs healed."""
        import heapq

        from ..storage.xlmeta import XLMeta

        def drive_walk(d):
            try:
                yield from d.walk_dir(bucket)
            except errors.StorageError:
                return

        walks = [
            drive_walk(d)
            for d in eo.disks
            if d is not None and d.is_online() and d is not disk
        ]
        current: str | None = None
        vids: set[str] = set()
        for name, raw in heapq.merge(*walks, key=lambda t: t[0]):
            if name != current:
                if current is not None:
                    yield current, vids
                current, vids = name, set()
            try:
                vids.update(v.version_id for v in XLMeta.from_bytes(raw).versions)
            except (errors.StorageError, ValueError):
                vids.add("")
        if current is not None:
            yield current, vids

    def _heal_drive(self, eo, disk, tracker: HealingTracker) -> None:
        try:
            buckets = sorted(v.name for v in disk_buckets(eo))
        except errors.StorageError:
            return
        # System bucket first: config/IAM/bucket-metadata shards must be
        # re-protected before anything else (the reference heals .minio.sys
        # first, cmd/background-newdisks-heal-ops.go).
        from ..object.erasure import META_BUCKET

        buckets = [META_BUCKET] + buckets
        since_checkpoint = 0
        for bucket in buckets:
            if tracker.resume_bucket and bucket < tracker.resume_bucket and bucket != META_BUCKET:
                continue
            try:
                disk.make_vol(bucket)
            except errors.StorageError:
                pass
            for name, version_ids in self._iter_set_versions(eo, disk, bucket):
                if self._stop.is_set():
                    # stop() mid-sweep: persist the cursor NOW so a restart
                    # resumes from this object instead of rescanning the
                    # whole namespace (a large-drive heal can take hours;
                    # losing the cursor on every rolling restart means the
                    # heal never converges).
                    try:
                        tracker.save(disk)
                    except errors.StorageError:
                        pass
                    return
                if (
                    bucket == tracker.resume_bucket
                    and tracker.resume_object
                    and name <= tracker.resume_object
                ):
                    continue
                tracker.objects_scanned += 1
                healed_any = failed_any = False
                for vid in sorted(version_ids) or [""]:
                    try:
                        res = eo.heal_object(bucket, name, vid)
                        healed_any = healed_any or res.disks_healed > 0
                    except errors.StorageError:
                        failed_any = True
                if healed_any:
                    tracker.objects_healed += 1
                if failed_any:
                    tracker.objects_failed += 1
                tracker.resume_bucket, tracker.resume_object = bucket, name
                since_checkpoint += 1
                if since_checkpoint >= self.checkpoint_every:
                    since_checkpoint = 0
                    try:
                        tracker.save(disk)
                    except errors.StorageError:
                        return  # drive vanished mid-heal; resume next tick
        tracker.finished = True
        try:
            tracker.save(disk)  # persist completion even if remove() fails
        except errors.StorageError:
            pass
        self.completed.append(tracker)
        HealingTracker.remove(disk)


def disk_buckets(eo) -> list:
    """Bucket volumes visible in an erasure set (excluding the sys volume)."""
    vols: dict[str, object] = {}
    for d in eo.disks:
        if d is None or not d.is_online():
            continue
        try:
            for v in d.list_vols():
                if not v.name.startswith("."):
                    vols.setdefault(v.name, v)
        except errors.StorageError:
            continue
    return list(vols.values())
