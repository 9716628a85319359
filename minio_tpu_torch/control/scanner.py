"""Background data scanner: usage accounting, heal sampling, lifecycle.

Role of the reference's cmd/data-scanner.go (initDataScanner :73, scanFolder
:368, dynamicSleeper :1277): a background loop that walks the namespace,
accumulates the usage tree, deep-scans a sample of objects for bitrot /
missing shards (1-in-N like the reference's 1/1024 sampling), triggers heals,
and evaluates lifecycle expiry. In a cluster the scanner runs only on the
node holding the leader lock (runDataScanner :99-111).

A copy of the JAX package's control/scanner.py, with the same RNG seed, so
both packages sample the same objects for the deep check. The deep check
heals through the layer's codec (on the card, the CUDA kernels), and a cycle
started before any codec is installed raises (`rebalance.require_codec`).
The event notifier (control/events.py) is not ported yet (ROADMAP.md,
Queue A item 8.3): `notifier` stays None and expiry emits no event.
"""

from __future__ import annotations

import random
import threading
import time

from ..storage.xlmeta import XLMeta
from ..utils import errors
from .lifecycle import Lifecycle
from .rebalance import require_codec
from .sanitizer import san_lock
from .usage import DataUsageCache

HEAL_SAMPLE = 128  # deep-check 1 in N objects per cycle (ref: 1/1024)


class DynamicSleeper:
    """Load-adaptive throttle: sleep proportional to work time
    (data-scanner.go:1277)."""

    def __init__(self, factor: float = 10.0, max_sleep: float = 1.0):
        self.factor = factor
        self.max_sleep = max_sleep

    def sleep(self, work_seconds: float) -> None:
        time.sleep(min(work_seconds * self.factor, self.max_sleep))


class DataScanner:
    def __init__(
        self,
        layer,
        bucket_meta=None,
        notifier=None,  # EventNotifier: None until Queue A item 8.3 (events)
        cycle_seconds: float = 60.0,
        heal_sample: int = HEAL_SAMPLE,
        leader_lock=None,
        store=None,
        tiering=None,
    ):
        self.layer = layer
        self.bucket_meta = bucket_meta
        self.notifier = notifier
        self.cycle_seconds = cycle_seconds
        self.heal_sample = heal_sample
        self.leader_lock = leader_lock
        self.store = store
        self.tiering = tiering
        self.usage = DataUsageCache()
        self.cycles_completed = 0
        self.objects_healed = 0
        self.objects_expired = 0
        self.uploads_aborted = 0
        self.objects_transitioned = 0
        # scan_cycle also runs synchronously (tests, admin-triggered
        # sweeps) concurrently with the loop thread: guard the counters.
        self._stats_lock = san_lock("DataScanner._stats_lock")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sleeper = DynamicSleeper()
        self._rng = random.Random(0x5CA77E2)

    # -- lifecycle of the scanner itself -------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True, name="data-scanner")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # A cycle in flight finishes its current object between sleeper
            # steps; bounded join keeps teardown from racing a live walk.
            self._thread.join(30.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.leader_lock is None or self.leader_lock.acquire(
                    writer=True, timeout=1.0
                ):
                    try:
                        self.scan_cycle()
                    finally:
                        if self.leader_lock is not None:
                            self.leader_lock.release()
            except Exception:  # noqa: BLE001 - scanner must never die
                pass
            self._stop.wait(self.cycle_seconds)

    # -- one cycle -----------------------------------------------------------

    def scan_cycle(self) -> None:
        require_codec(self.layer)
        fresh = DataUsageCache()
        for bucket in [b.name for b in self.layer.list_buckets()]:
            lc = self._lifecycle_for(bucket)
            for pool in self.layer.pools:
                try:
                    walker = pool._walk_merged(bucket)
                except errors.StorageError:
                    continue
                for name, raw in walker:
                    t0 = time.perf_counter()
                    try:
                        meta = XLMeta.from_bytes(raw)
                        fi = meta.file_info("")
                    except errors.StorageError:
                        continue
                    if not fi.deleted:
                        fresh.record(bucket, name, fi.size, len(meta.versions))
                    # Lifecycle expiry / transition-to-tier.
                    if lc is not None:
                        action = lc.eval(name, fi.mod_time, fi.deleted)
                        if action == "expire":
                            self._expire(bucket, name, fi)
                            continue
                        if action.startswith("transition:"):
                            self._transition(bucket, name, fi, action.split(":", 1)[1])
                    # Heal sampling: deep-verify 1 in heal_sample objects.
                    if self._rng.randrange(self.heal_sample) == 0:
                        self._deep_check(bucket, name)
                    self._sleeper.sleep(time.perf_counter() - t0)
            # Stale incomplete multipart uploads (the reference's scanner
            # applies AbortIncompleteMultipartUpload rules per bucket).
            # Capability is tested explicitly so a real AttributeError inside
            # the listing code still surfaces instead of silently disabling
            # the sweep.
            list_mpu = getattr(self.layer, "list_multipart_uploads", None)
            abort_mpu = getattr(self.layer, "abort_multipart_upload", None)
            if (
                lc is not None
                and list_mpu is not None
                and abort_mpu is not None
                and any(r.abort_mpu_days for r in lc.rules)
            ):
                try:
                    uploads = list_mpu(bucket)
                except errors.StorageError:
                    uploads = []
                for up in uploads:
                    if lc.eval_abort_mpu(up["object"], up["initiated"]):
                        t0 = time.perf_counter()
                        try:
                            abort_mpu(bucket, up["object"], up["upload_id"])
                            with self._stats_lock:
                                self.uploads_aborted += 1
                        except errors.StorageError:
                            pass
                        self._sleeper.sleep(time.perf_counter() - t0)
        fresh.finish()
        self.usage = fresh
        with self._stats_lock:
            self.cycles_completed += 1
        if self.tiering is not None:
            try:
                self.tiering.drain_journal()
                self.tiering.expire_restored_copies(self.layer)
            except Exception:  # noqa: BLE001
                pass
        if self.store is not None:
            try:
                self.store.put("scanner/data-usage.json", fresh.to_bytes())
            except errors.StorageError:
                pass

    def _lifecycle_for(self, bucket: str) -> Lifecycle | None:
        if self.bucket_meta is None:
            return None
        raw = self.bucket_meta.get(bucket).lifecycle_xml
        if not raw:
            return None
        try:
            return Lifecycle.from_xml(raw)
        except Exception:  # noqa: BLE001
            return None

    def _expire(self, bucket: str, name: str, fi=None) -> None:
        try:
            # On versioned buckets expiry writes a delete marker (the data
            # stays as a noncurrent version, like the reference's scanner);
            # unversioned buckets delete outright.
            versioned = False
            if self.bucket_meta is not None:
                try:
                    versioned = self.bucket_meta.get(bucket).versioning_enabled()
                except Exception:  # noqa: BLE001
                    pass
            from ..object.types import DeleteObjectOptions

            self.layer.delete_object(bucket, name, DeleteObjectOptions(versioned=versioned))
            # A permanent expiry of a transitioned version reclaims the
            # remote copy — journaled only after the local delete succeeded.
            # Marker creation keeps the data referenced, so no journaling.
            if not versioned and self.tiering is not None and fi is not None:
                from .tiering import is_transitioned

                if is_transitioned(fi.metadata):
                    self.tiering.journal_delete(fi.metadata)
            with self._stats_lock:
                self.objects_expired += 1
            # The JAX scanner emits s3:ObjectRemoved:Expired to its notifier
            # here; the port's events wait for Queue A item 8.3.
        except errors.StorageError:
            pass

    def _transition(self, bucket: str, name: str, fi, tier: str) -> None:
        if self.tiering is None:
            return
        from .tiering import is_transitioned

        if is_transitioned(fi.metadata) or fi.deleted:
            return
        try:
            self.tiering.transition(self.layer, bucket, name, fi.version_id, tier)
            with self._stats_lock:
                self.objects_transitioned += 1
        except Exception:  # noqa: BLE001 - unreachable tier (raw requests
            pass  # errors) must not abort the whole scan cycle

    def _deep_check(self, bucket: str, name: str) -> None:
        try:
            res = self.layer.heal_object(bucket, name, dry_run=True)
            if res.disks_healed:
                real = self.layer.heal_object(bucket, name)
                with self._stats_lock:
                    self.objects_healed += real.disks_healed and 1 or 0
        except errors.StorageError:
            pass
