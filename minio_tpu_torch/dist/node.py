"""Node bootstrap: endpoints -> drives -> format consensus -> full server.

Role of the reference's server-main.go serverMain (:422) + endpoint.go
CreateEndpoints (:538) + prepare-storage.go waitForFormatErasure: each node
is given the SAME ordered endpoint list; it opens local paths as the
metered, breaker-gated, fault-injectable drive stack and remote paths
through the storage REST proxy, installs the data-plane codec (runtime.py:
the device probe, then the batching codec on the card), reaches format.json
quorum per pool (creating fresh formats when the whole pool is unformatted
and this node is the leader = owner of the first endpoint), assembles the
erasure pools and the control plane, and serves S3 + admin + storage, lock
and peer REST on one port.

The pool manager (attach, decommission, rebalance), the data scanner,
TierConfigMgr, metrics, the event notifier with its targets, the flight
recorder, bucket and site replication, the console, the etcd IAM store,
and the disk and memory caches (MTPU_CACHE_DRIVES, MTPU_MEMCACHE_MB; the S3
front serves the outermost cache layer, background subsystems the raw
pools) are wired as the JAX node wires them.
"""

from __future__ import annotations

import os
import time
import urllib.parse
import weakref
from dataclasses import dataclass

from aiohttp import web

from ..api.auth import Credentials
from ..api.server import S3Server
from ..control.iam import IAMSys
from ..object import codec as codec_mod
from ..object.pools import ServerPools
from ..object.sets import ErasureSets
from ..storage import format as fmt_mod
from ..storage.interface import StorageAPI
from ..storage.local import LocalDrive
from ..utils import errors
from .locks import LOCK_PREFIX, LocalLocker, NamespaceLock, RemoteLocker, make_lock_app
from .peer import PEER_PREFIX, NotificationSys, PeerClient, make_peer_app
from .storage_rest import PREFIX as STORAGE_PREFIX
from .storage_rest import RemoteDrive, make_storage_app
from .transport import cluster_token


@dataclass
class Endpoint:
    url: str  # "" for pure-local path endpoints
    path: str

    @property
    def is_local_path(self) -> bool:
        return not self.url

    @classmethod
    def parse(cls, raw: str) -> "Endpoint":
        if raw.startswith(("http://", "https://")):
            u = urllib.parse.urlparse(raw)
            return cls(url=f"{u.scheme}://{u.netloc}", path=u.path)
        return cls(url="", path=raw)


class Node:
    # Every constructed node, for close_all() (weak: an abandoned node that
    # never built threads may simply be collected).
    _live: "weakref.WeakSet[Node]" = weakref.WeakSet()

    def __init__(
        self,
        endpoints: list[str],
        url: str = "",
        root_user: str = "minioadmin",
        root_password: str = "minioadmin",
        set_drive_count: int | None = None,
        parity: int | None = None,
        rrs_parity: int | None = None,
        region: str = "us-east-1",
        codec: codec_mod.BlockCodec | None = None,
        check_skew: bool = False,
        device="cuda",
    ):
        Node._live.add(self)
        self.url = url.rstrip("/")
        # endpoints: flat list (one pool) or list of lists (server pools --
        # each argument group is an independent pool, the reference's
        # `minio server poolA{1...n} poolB{1...n}` expansion,
        # cmd/endpoint-ellipses.go multi-arg pools).
        if endpoints and isinstance(endpoints[0], (list, tuple)):
            pool_specs = [list(p) for p in endpoints]
        else:
            pool_specs = [list(endpoints)]
        self.pool_endpoints = [[Endpoint.parse(e) for e in pool] for pool in pool_specs]
        self.endpoints = [ep for pool in self.pool_endpoints for ep in pool]
        self.token = cluster_token(root_password)
        self.creds = Credentials(root_user, root_password)
        self.region = region
        self.codec = codec
        self.device = device
        self._own_codec = None  # the codec build() built, closed by close()
        # The codec build() made the process default (its own or the
        # caller's): close() clears the default while it is still this one.
        self._installed_codec = None

        # Drive construction: local paths open directly, remote via REST.
        peer_urls: set[str] = set()
        from ..chaos.disk import FaultyDisk
        from ..control.pubsub import GLOBAL_TRACE
        from ..storage.breaker import HealthGatedDrive
        from ..storage.metered import MeteredDrive

        self.local_drives: dict[str, StorageAPI] = {}
        self.pool_drives: list[list[StorageAPI]] = []
        for pool in self.pool_endpoints:
            drives: list[StorageAPI] = []
            for ep in pool:
                if not (ep.is_local_path or ep.url == self.url):
                    peer_urls.add(ep.url)
                    drives.append(RemoteDrive(ep.url, ep.path, self.token))
                    continue
                # Local drives are metered (per-API latency EWMAs + storage
                # traces, xl-storage-disk-id-check.go role) over the circuit
                # breaker + admission gate (storage/breaker.py) over the
                # fault-injection seam (admin /chaos arms faults in the
                # process-global registry; disarmed, FaultyDisk resolves to
                # the inner bound method -- no extra frame). Breaker INSIDE
                # the meter so fail-fast refusals are timed/counted;
                # FaultyDisk inside the breaker so injected faults trip it
                # exactly like kernel EIOs.
                d = MeteredDrive(
                    HealthGatedDrive(FaultyDisk(LocalDrive(ep.path))),
                    trace=GLOBAL_TRACE,
                )
                self.local_drives[ep.path] = d
                drives.append(d)
            self.pool_drives.append(drives)
        self.drives = [d for pool in self.pool_drives for d in pool]
        self.peer_urls = sorted(peer_urls)

        # One set size must fit every pool (the reference requires per-pool
        # divisibility too; set count may differ per pool).
        self.set_drive_count = set_drive_count or _default_set_count(len(self.pool_drives[0]))
        for pi, drives in enumerate(self.pool_drives):
            if len(drives) % self.set_drive_count:
                raise ValueError(
                    f"pool {pi}: {len(drives)} drives not divisible into "
                    f"sets of {self.set_drive_count}"
                )
        self.parity = parity
        self.rrs_parity = rrs_parity
        # Leader = the node owning the first endpoint (server-main.go:507
        # "first local" orchestrates format).
        first = self.endpoints[0]
        self.is_leader = first.is_local_path or first.url == self.url

        self.locker = LocalLocker()
        self.iam: IAMSys | None = None
        self.s3: S3Server | None = None
        self.pools: ServerPools | None = None
        self.ns_lock: NamespaceLock | None = None
        self.notification: NotificationSys | None = None
        self.poolmgr = None
        self.scanner = None
        self.tiering = None
        self.metrics = None
        self.notifier = None
        self.replication = None
        self.site_repl = None
        self.cache = None  # CacheObjectLayer (MTPU_CACHE_DRIVES)
        self.memcache = None  # MemObjectCache (MTPU_MEMCACHE_MB)
        self._quota_cache = None  # leader-persisted usage tree (non-leaders)
        self._quota_cache_ts = 0.0

    # -- format consensus ----------------------------------------------------

    def _read_formats(self, drives) -> list[fmt_mod.DriveFormat | None]:
        out: list[fmt_mod.DriveFormat | None] = []
        for d in drives:
            try:
                raw = d.read_all(fmt_mod.SYS_DIR, fmt_mod.FORMAT_FILE)
                out.append(fmt_mod.DriveFormat.from_json(raw.decode()))
            except (errors.DiskError, errors.FileCorrupt):
                out.append(None)
        return out

    def wait_for_format(
        self,
        timeout: float = 30.0,
        drives: list | None = None,
        deployment_id: str | None = None,
    ) -> fmt_mod.DriveFormat:
        """Reach format quorum for one pool's drives, creating fresh formats
        if the whole pool is unformatted, every drive answers and this node
        leads (prepare-storage.go role). Pools after the first inherit the
        cluster deployment id."""
        drives = self.drives if drives is None else drives
        deadline = time.monotonic() + timeout
        while True:
            formats = self._read_formats(drives)
            n_fmt = sum(1 for f in formats if f is not None)
            # A fresh pool is formatted only once every drive answers: a drive
            # whose node is not serving yet would stay unformatted, and the
            # quorum out of reach (the reference formats only when all disks
            # report errUnformattedDisk, prepare-storage.go; the JAX node
            # formats the drives it can reach).
            if n_fmt == 0 and self.is_leader and all(d.is_online() for d in drives):
                n_sets = len(drives) // self.set_drive_count
                fresh = fmt_mod.init_format(
                    n_sets, self.set_drive_count, deployment_id=deployment_id
                )
                for d, f in zip(drives, fresh):
                    try:
                        d.write_all(fmt_mod.SYS_DIR, fmt_mod.FORMAT_FILE, f.to_json().encode())
                    except errors.DiskError:
                        pass
                continue
            if n_fmt > 0:
                try:
                    quorum = fmt_mod.quorum_format(formats)
                except errors.StorageError:
                    quorum = None
                if quorum is not None:
                    # Heal format onto unformatted drives that we can reach:
                    # give each missing slot the id the quorum expects.
                    flat_ids = [i for s in quorum.sets for i in s]
                    for d, f in zip(drives, formats):
                        if f is None and d.is_online():
                            # Which slot is this drive? By position in the
                            # endpoint list (the reference heals by position
                            # too, format-erasure.go:783).
                            idx = drives.index(d)
                            if idx < len(flat_ids):
                                healed = fmt_mod.DriveFormat(
                                    deployment_id=quorum.deployment_id,
                                    this_id=flat_ids[idx],
                                    sets=quorum.sets,
                                    distribution_algo=quorum.distribution_algo,
                                )
                                try:
                                    d.write_all(
                                        fmt_mod.SYS_DIR,
                                        fmt_mod.FORMAT_FILE,
                                        healed.to_json().encode(),
                                    )
                                    # Fresh drive joined: mark it for a
                                    # background heal sweep (the reference
                                    # drops .healing.bin at format-heal,
                                    # background-newdisks-heal-ops.go:48).
                                    from ..control.healmgr import mark_drive_for_healing

                                    mark_drive_for_healing(d, healed.this_id)
                                except errors.DiskError:
                                    pass
                    return quorum
            if time.monotonic() > deadline:
                raise errors.UnformattedDisk("format quorum not reached")
            time.sleep(0.25)

    # -- assembly ------------------------------------------------------------

    def build(self) -> "Node":
        layer_codec = self.codec
        if self.codec is None:
            # Install the served data-plane codec: on "cuda" the probe child
            # must launch both kernels on the card, and a failed verdict
            # raises here -- before the S3 front exists, so requests keep
            # answering 503 and serve() exits FATAL. On "cpu" the batching
            # codec runs the plain versions, as the caller asked. The layer
            # is built with codec=None, so it resolves the process default.
            from ..runtime import install_data_plane_codec

            self.codec = self._own_codec = install_data_plane_codec(device=self.device)
            layer_codec = None
        else:
            codec_mod.set_default_codec(self.codec)
        self._installed_codec = self.codec
        # One ErasureSets per pool; pools after the first share the cluster
        # deployment id (erasure-server-pool.go newErasureServerPools role).
        pool_sets: list[ErasureSets] = []
        dep_id: str | None = None
        for pi, drives in enumerate(self.pool_drives):
            quorum = self.wait_for_format(drives=drives, deployment_id=dep_id)
            if dep_id is not None and quorum.deployment_id != dep_id:
                # A pre-formatted pool from a DIFFERENT cluster must not be
                # silently merged into this namespace (the reference rejects
                # mismatched deployment ids at startup).
                raise errors.UnformattedDisk(
                    f"pool {pi} belongs to deployment {quorum.deployment_id}, "
                    f"cluster is {dep_id}"
                )
            dep_id = dep_id or quorum.deployment_id
            pool_sets.append(
                ErasureSets.from_drives(
                    list(drives), quorum, parity=self.parity, codec=layer_codec,
                    pool_index=pi, rrs_parity=self.rrs_parity,
                )
            )
        self.pools = ServerPools(pool_sets)
        lockers: list = [self.locker] + [RemoteLocker(u, self.token) for u in self.peer_urls]
        self.ns_lock = NamespaceLock(lockers)
        self.pools.ns_lock = self.ns_lock
        for sets in pool_sets:
            for s in sets.sets:
                s.ns_lock = self.ns_lock
        self.iam = IAMSys(self.creds.access_key, self.creds.secret_key)
        from ..control import kms as kms_mod
        from ..control.kms import StaticKeyKMS, kms_from_env

        # An explicitly configured KMS (env) is honored even if the crypto
        # backend is missing -- failing loudly beats silently dropping the
        # operator's encryption intent. The implicit ephemeral key, though,
        # only exists to make SSE work out of the box; without the backend
        # it can't, so run as a KMS-less node.
        self.kms = kms_from_env()
        if self.kms is None and kms_mod.AESGCM is not None:
            self.kms = StaticKeyKMS()
        self.notification = NotificationSys(
            [PeerClient(u, self.token) for u in self.peer_urls]
        )
        # Pool lifecycle manager: owns attach/decommission/rebalance and the
        # persisted pool-config epoch. load_config() here picks up pools that
        # were attached at runtime before this process (re)started -- built
        # BEFORE the subsystems below so they all see the full pool set.
        from ..object.poolmgr import PoolManager

        self.poolmgr = PoolManager(
            self.pools, notification=self.notification, node=self
        )
        self.poolmgr.load_config()

        # Control plane assembly (newAllSubsystems role, server-main.go:451).
        from ..control.config import ConfigStore, ConfigSys
        from ..control.healmgr import HealManager, MRFQueue
        from ..control.logging import GLOBAL_LOGGER
        from ..control.pubsub import GLOBAL_TRACE

        store = ConfigStore(self.pools)
        self.config = ConfigSys(store)
        try:
            self.config.load()
        except errors.StorageError:
            pass
        # IAM durability (iam-object-store.go role): users/policies persist
        # through the erasure-backed config store (sealed with the root
        # credential) and reload on boot -- or through etcd when configured
        # (iam-etcd-store.go role; the reference prefers etcd whenever it
        # is set, which is how federated/gateway deployments share IAM).
        # A FAILED load (degraded quorum) disables persistence for this
        # process instead of risking an empty snapshot overwriting the
        # real one on the next mutation.
        from ..control.etcd import etcd_store_from_env

        self.iam.store = etcd_store_from_env() or store
        self.iam.ns_lock = self.ns_lock
        try:
            self.iam.load()
        except errors.FileCorrupt:
            # Unseal failure = wrong root credential, not a flaky drive.
            # Booting anyway would silently serve with ZERO identities;
            # fail loudly instead so the operator restores the credential.
            raise
        except errors.StorageError as e:
            backend = "etcd" if self.iam.store is not store else "erasure config store"
            self.iam.store = None
            self.iam.ns_lock = None
            GLOBAL_LOGGER.error(
                f"IAM store ({backend}) unreadable at boot ({e}); IAM "
                "persistence DISABLED for this process -- identities created now "
                f"will not survive a restart. Restore the {backend} and restart.",
                exc=e,
            )
        # Optional SSD read-cache in front of the object layer for the S3
        # serving path only -- background subsystems keep the raw layer
        # (the reference interposes CacheObjectLayer at the handler level,
        # object-handlers.go:1722-1724).
        from ..object.cache import CacheConfig, CacheObjectLayer

        cache_cfg = CacheConfig.from_env()
        self.cache = CacheObjectLayer(self.pools, cache_cfg) if cache_cfg else None
        # Hot tier above the disk cache: an in-memory coherent LRU
        # (MTPU_MEMCACHE_MB). Writes through the serving layer invalidate
        # every peer's memcache BEFORE acking, via the same peer channel
        # bucket metadata rides (object/memcache.py).
        from ..object.memcache import (
            MemCacheConfig,
            MemCacheObjectLayer,
            MemObjectCache,
        )

        mem_cfg = MemCacheConfig.from_env()
        self.memcache = MemObjectCache(mem_cfg) if mem_cfg else None
        serving_layer = self.cache if cache_cfg else self.pools
        if self.memcache is not None:
            serving_layer = MemCacheObjectLayer(
                serving_layer,
                self.memcache,
                on_invalidate=(
                    lambda b, o: self.notification.invalidate_memcache_all(b, o)
                ),
            )
        s3 = S3Server(
            serving_layer,
            self.iam,
            region=self.region,
            check_skew=False,
            kms=self.kms,
            config=self.config,
        )
        from ..control.event_targets import configure_targets
        from ..control.events import EventNotifier
        from ..control.metrics import MetricsSys
        from ..storage.format import SYS_DIR

        self.metrics = MetricsSys()
        self.metrics.layer = self.pools
        self.trace = GLOBAL_TRACE
        self.logger = GLOBAL_LOGGER
        self.notifier = EventNotifier()
        # Durable event spool on the first local drive (queuestore.go keeps
        # its spool under the local config dir too).
        spool_root = ""
        if self.local_drives:
            first = next(iter(self.local_drives))
            spool_root = os.path.join(first, SYS_DIR, "notify-spool")
        self.notify_target_errors: dict[str, str] = {}

        def _target_err(tid, e):
            self.notify_target_errors[tid] = str(e)
            GLOBAL_LOGGER.error(f"notify target {tid} disabled: {e}", exc=e)

        configure_targets(self.notifier, self.config, spool_root, on_error=_target_err)
        s3.metrics = self.metrics
        s3.trace = self.trace
        s3.logger = self.logger
        s3.notifier = self.notifier
        # Every durable bucket-meta mutation (from ANY writer: S3 handlers,
        # the target registry, quota admin) broadcasts the peer
        # invalidation -- the meta cache has no TTL.
        s3.bucket_meta.on_change = lambda b: self.notification.reload_bucket_meta_all(b)
        # Cluster-wide watcher streams: listen/trace responses merge every
        # peer's records (ListenNotification + admin trace peer subscription).
        s3.peer_notification = self.notification
        # Hard bucket quotas read the scanner's usage tree
        # (enforceBucketQuota, cmd/bucket-quota.go:112).
        s3.quota_usage = self._quota_usage
        # Bucket replication: its workers read replicas through the pools
        # (the erasure GET, so the card verifies and rebuilds them) and feed
        # the one bandwidth monitor that admin /bandwidth, the peer verb and
        # /metrics read. Site replication rides on it.
        from ..control.replication import BucketTargetSys, ReplicationSys
        from ..control.site_replication import SiteReplicationSys

        self.replication = ReplicationSys(
            self.pools,
            s3.bucket_meta,
            BucketTargetSys(s3.bucket_meta, kms=self.kms),
            kms=self.kms,
        )
        s3.replication = self.replication
        self.metrics.replication = self.replication
        self.site_repl = SiteReplicationSys(
            self.pools,
            s3.bucket_meta,
            self.iam,
            self.replication.targets,
            self.replication,
            store,
            self_endpoint=self.url,
            notifier=self.notifier,
        )
        s3.site_repl = self.site_repl
        self.healmgr = HealManager(self.pools)
        self.mrf = MRFQueue(self.pools)
        # Feed the MRF from every erasure set: a put that met quorum but
        # missed drives queues an async repair instead of waiting for the
        # scanner sweep (erasure-object.go:1430 addPartial -> mrf queue).
        for pool in self.pools.pools:
            for s in pool.sets:
                s.on_partial = self.mrf.add
        # Crash-consistency plane: arm any boot-time crash schedule (crash
        # victims arm via MTPU_CRASH since the admin API isn't up yet), then
        # sweep crash debris off the local drives before serving: a dead
        # process's pid-scoped stage files are GC'd here, and partially
        # committed versions are fed to the MRF heal queue.
        from ..chaos import crash as _crash
        from ..storage import recovery as _recovery

        _crash.arm_from_env()
        if os.environ.get("MTPU_RECOVERY", "1") != "0":
            for path in self.local_drives:
                try:
                    _recovery.recover_drive(LocalDrive(path))
                except Exception as e:  # noqa: BLE001 - boot must not die on a sweep
                    GLOBAL_LOGGER.error(f"recovery scan failed on {path}: {e}", exc=e)
            for pool in self.pools.pools:
                for s in pool.sets:
                    if all(d is None or d.is_local() for d in s.disks):
                        try:
                            _recovery.recover_set(s, heal=self.mrf.add)
                        except Exception as e:  # noqa: BLE001
                            GLOBAL_LOGGER.error(f"set recovery scan failed: {e}", exc=e)
        from ..control.healmgr import DiskHealMonitor

        self.disk_heal = DiskHealMonitor(self.pools)
        from ..control.scanner import DataScanner
        from ..control.tiering import TierConfigMgr

        self.tiering = TierConfigMgr(store, kms=self.kms)
        s3.tiering = self.tiering
        # Scanner leadership via a never-released dsync lock (runDataScanner
        # :99-111); only one node in the cluster scans at a time.
        self.scanner = DataScanner(
            self.pools,
            bucket_meta=s3.bucket_meta,
            notifier=self.notifier,
            leader_lock=self.ns_lock.new(".minio_tpu.sys", "leader/data-scanner"),
            store=store,
            tiering=self.tiering,
        )
        # Metrics sources for the node exposition (drive series come through
        # metrics.layer; these feed heal/scanner progress and cluster fan-out).
        self.metrics.memcache = self.memcache
        self.metrics.node_url = self.url
        self.metrics.notification = self.notification
        self.metrics.scanner = self.scanner
        self.metrics.healmgr = self.healmgr
        self.metrics.mrf = self.mrf
        self.metrics.disk_heal = self.disk_heal
        self.metrics.poolmgr = self.poolmgr
        self.metrics.notifier = self.notifier
        # Rehydrate notification rules from persisted bucket metadata: the
        # notifier starts empty, and without this pass a restart silently
        # stops event delivery for every configured bucket until an
        # operator re-PUTs the config. Parallel: serial per-bucket quorum
        # reads would add O(buckets) to boot on large namespaces.
        from ..object import metadata as _meta_mod

        _meta_mod.parallel_map(
            lambda b: self.refresh_bucket_notification(b.name, s3=s3),
            self.pools.list_buckets(),
        )
        # Arm the always-on profiling plane (continuous stack sampler + GIL
        # probe; MTPU_PROFILE=0 vetoes). Process-wide singleton, stopped by
        # close_all().
        from ..control.profiler import GLOBAL_PROFILER

        GLOBAL_PROFILER.ensure_started()
        # Arm the flight recorder's trigger engine (control/flight.py;
        # MTPU_FLIGHT=0 vetoes -- tests default it off in conftest.py) and
        # wire this node's identity + incident fanout into the process
        # singleton. Last node registered wins: one node per process in
        # production; in-process cluster peers still capture under their
        # own tags via the flightcapture peer verb. close() takes back what
        # this node wired, close_all() stops the engine.
        from ..control.flight import GLOBAL_FLIGHT

        GLOBAL_FLIGHT.register_node(
            self.url,
            fanout=self.notification.flight_capture_all,
            pool_status_fn=self.poolmgr.status,
        )
        GLOBAL_FLIGHT.ensure_started()
        # Serve last: until here the S3 entry and the admin routes answer 503.
        self.s3 = s3
        # Resume any drain the previous process left running (the leader
        # drives drains, like format orchestration; MTPU_POOL_RESUME=0
        # vetoes for surgical restarts).
        if self.is_leader and os.environ.get("MTPU_POOL_RESUME", "1") != "0":
            self.poolmgr.resume_pending()
        return self

    def refresh_bucket_notification(self, bucket: str, s3=None) -> None:
        """Load one bucket's notifier rules from its persisted metadata —
        the single implementation boot rehydration (which passes the front
        build() has not published yet) and the peer reload handler share.
        Error policy: bucket gone -> clear the rules; transient read
        failure or malformed XML -> KEEP the current rules (silently
        dropping events on a flap would be worse than serving one stale
        rule set)."""
        s3 = s3 if s3 is not None else self.s3
        if s3 is None or self.notifier is None:
            return
        try:
            xml = s3.bucket_meta.get(bucket).notification_xml or ""
        except (errors.ObjectNotFound, errors.BucketNotFound):
            xml = ""  # bucket deleted: no rules
        except errors.StorageError:
            return  # transient: keep what we have
        try:
            self.notifier.set_bucket_rules_from_xml(bucket, xml)
        except Exception as e:  # noqa: BLE001 - malformed persisted XML
            self.logger.error(f"notification rules for {bucket} unparsable", exc=e)
            return

    def _quota_usage(self, bucket: str) -> int | None:
        """Bucket usage bytes for quota enforcement, or None when unknown.

        Only the scan leader populates its in-memory tree; every other node
        reads the tree the leader persists (scanner/data-usage.json),
        TTL-cached ~1s like the reference's bucketStorageCache
        (cmd/bucket-quota.go:72-78). No tree anywhere -> None (enforcement
        skipped until a first scan completes)."""
        sc = self.scanner
        if sc is not None and sc.usage.last_update:
            return sc.usage.bucket_usage(bucket).size
        now = time.monotonic()
        if now - self._quota_cache_ts > 1.0:
            self._quota_cache_ts = now
            self._quota_cache = None
            store = getattr(sc, "store", None)
            if store is not None:
                try:
                    raw = store.get("scanner/data-usage.json")
                    if raw:
                        from ..control.usage import DataUsageCache

                        self._quota_cache = DataUsageCache.from_bytes(raw)
                except Exception as e:  # noqa: BLE001 - unreadable tree = unknown
                    self.logger.log_once(
                        f"usage tree unreadable, quota enforcement skipped: {e}",
                        key="quota-usage-tree",
                    )
                    self._quota_cache = None
        cache = self._quota_cache
        if cache is None or not cache.last_update:
            return None
        return cache.bucket_usage(bucket).size

    # -- pool expansion -------------------------------------------------------

    def build_pool_from_endpoints(self, raw_endpoints: list[str]) -> ErasureSets:
        """Construct (and register) the drive stacks + erasure sets for one
        new pool at runtime. Formats the drives with the cluster deployment
        id when ALL of them are unformatted (the attach orchestrator
        formats regardless of boot leadership -- wait_for_format only
        auto-inits for the leader); a pre-formatted foreign pool is
        rejected. Called by attach_pool on the orchestrating node and by
        PoolManager.load_config on peers replaying the persisted config."""
        if self.pools is None:
            raise errors.StorageError("node not built yet")
        from ..chaos.disk import FaultyDisk
        from ..control.pubsub import GLOBAL_TRACE
        from ..storage.breaker import HealthGatedDrive
        from ..storage.metered import MeteredDrive

        eps = [Endpoint.parse(e) for e in raw_endpoints]
        drives: list[StorageAPI] = []
        for ep in eps:
            if ep.is_local_path or ep.url == self.url:
                d = MeteredDrive(
                    HealthGatedDrive(FaultyDisk(LocalDrive(ep.path))),
                    trace=GLOBAL_TRACE,
                )
                # Registering here makes the drive instantly peer-servable:
                # make_storage_app resolves this dict at request time.
                self.local_drives[ep.path] = d
                drives.append(d)
            else:
                drives.append(RemoteDrive(ep.url, ep.path, self.token))
        if len(drives) % self.set_drive_count:
            raise ValueError(
                f"attached pool: {len(drives)} drives not divisible into "
                f"sets of {self.set_drive_count}"
            )
        dep_id = self.pools.pools[0].deployment_id
        if not any(f is not None for f in self._read_formats(drives)):
            n_sets = len(drives) // self.set_drive_count
            fresh = fmt_mod.init_format(
                n_sets, self.set_drive_count, deployment_id=dep_id
            )
            for d, f in zip(drives, fresh):
                try:
                    d.write_all(
                        fmt_mod.SYS_DIR, fmt_mod.FORMAT_FILE, f.to_json().encode()
                    )
                except errors.DiskError:
                    pass
        quorum = self.wait_for_format(
            timeout=10.0, drives=drives, deployment_id=dep_id
        )
        if quorum.deployment_id != dep_id:
            raise errors.UnformattedDisk(
                f"attached pool belongs to deployment {quorum.deployment_id}, "
                f"cluster is {dep_id}"
            )
        # As build() gives its pools: the caller's codec, else the default.
        layer_codec = None if self._own_codec is not None else self.codec
        sets = ErasureSets.from_drives(
            list(drives), quorum, parity=self.parity, codec=layer_codec,
            pool_index=len(self.pools.pools), rrs_parity=self.rrs_parity,
        )
        self.pool_endpoints.append(eps)
        self.endpoints.extend(eps)
        self.pool_drives.append(drives)
        self.drives.extend(drives)
        return sets

    def _wire_new_pool(self, sets: ErasureSets) -> None:
        """Give a runtime-attached pool the same plumbing build() gives boot
        pools: the namespace lock and the partial-write -> MRF feed."""
        mrf = getattr(self, "mrf", None)
        for s in sets.sets:
            s.ns_lock = self.ns_lock
            if mrf is not None:
                s.on_partial = mrf.add

    def attach_pool(self, raw_endpoints: list[str]) -> int:
        """Runtime attach-pool expansion: build drives + sets, wire them,
        then run the manager's two-phase (suspended -> fanout -> active ->
        fanout) attach. Returns the new pool index."""
        sets = self.build_pool_from_endpoints(list(raw_endpoints))
        self._wire_new_pool(sets)
        return self.poolmgr.attach(sets, endpoints=list(raw_endpoints))

    def reload_pools(self) -> bool:
        """Peer-RPC entry: re-read the persisted pool config (epoch-gated)."""
        pm = getattr(self, "poolmgr", None)
        if pm is None:
            return False
        return pm.load_config()

    # -- shutdown ------------------------------------------------------------

    def close(self) -> None:
        """Stop every background worker this node started, reverse build
        order (consumers before their feeds), clear the process default codec
        while it is still the one build() installed, and close that codec if
        build() built it (a caller's codec stays the caller's to close).
        It also takes back what build() wired into process-wide state: the
        flight recorder's registration and engine, while they are still
        this node's, and the pumps of this node's listen streams.
        Idempotent, and safe on a node that never completed build() -- each
        subsystem is stopped only if it exists."""
        for sub in ("site_repl", "replication"):
            s = getattr(self, sub, None)
            if s is not None:
                s.close()
        for sub in ("poolmgr", "scanner", "disk_heal", "mrf", "healmgr"):
            s = getattr(self, sub, None)
            if s is not None:
                s.stop()
        notifier = self.notifier
        if notifier is not None:
            for t in list(notifier.targets.values()):
                t.close()
            from ..api.streams import close_bridges

            close_bridges(notifier.listen_hub)
        if self.notification is not None:
            from ..control.flight import GLOBAL_FLIGHT

            if GLOBAL_FLIGHT.unregister_node(self.url, self.notification.flight_capture_all):
                GLOBAL_FLIGHT.stop()
        installed, self._installed_codec = self._installed_codec, None
        if installed is not None:
            with codec_mod._default_lock:
                if codec_mod._default is installed:
                    codec_mod._default = None
        own, self._own_codec = self._own_codec, None
        if own is not None:
            close = getattr(own, "close", None)
            if close is not None:
                close()
        Node._live.discard(self)

    @classmethod
    def close_all(cls) -> None:
        """Close every live node in the process -- the teardown hook for
        test sessions and embedded setups, where nodes are built ad hoc and
        nothing else owns their lifetime."""
        for node in list(cls._live):
            node.close()
        # The profiling and flight planes and the trace hub are process-wide
        # (not per-node), so they stop here -- after the last node -- rather
        # than in close(); buffering log targets flush for the same reason.
        from ..control.profiler import GLOBAL_PROFILER

        GLOBAL_PROFILER.stop()
        from ..control.flight import GLOBAL_FLIGHT

        GLOBAL_FLIGHT.stop()
        from ..api.streams import close_bridges
        from ..control.pubsub import GLOBAL_TRACE

        close_bridges(GLOBAL_TRACE.hub)
        from ..control.logging import GLOBAL_LOGGER

        GLOBAL_LOGGER.close()

    def make_app(self) -> web.Application:
        """One aiohttp app: internode routers first, then admin, S3 catch-all
        last (routers.go:65 ordering). Servable BEFORE build() -- the S3
        handler and the admin routes 503 until the object layer is up, so
        peers can reach this node's storage REST during the format handshake
        (the reference starts its dist routers before waitForFormatErasure
        too, server-main.go:495-521)."""
        app = web.Application(client_max_size=1 << 31)
        app.add_subapp(STORAGE_PREFIX, make_storage_app(self.local_drives, self.token))
        app.add_subapp(LOCK_PREFIX, make_lock_app(self.locker, self.token))
        app.add_subapp(PEER_PREFIX, make_peer_app(self, self.token))
        from ..api.admin import ADMIN_PREFIX, make_admin_app

        app.add_subapp(ADMIN_PREFIX, make_admin_app(_LazyAdminContext(self)))
        from ..api.console import CONSOLE_PREFIX, make_console_app

        app.add_subapp(CONSOLE_PREFIX, make_console_app(_LazyAdminContext(self)))

        async def s3_entry(request: web.Request):
            if self.s3 is None:
                return web.Response(status=503, text="server initializing")
            return await self.s3._entry(request)

        app.router.add_route("*", "/{tail:.*}", s3_entry)
        return app


class _LazyAdminContext:
    """Admin context resolving node components at request time, so the admin
    router can be mounted before build() completes (it 503s until ready)."""

    def __init__(self, node: "Node"):
        self._node = node

    @property
    def ready(self) -> bool:
        return self._node.s3 is not None

    @property
    def layer(self):
        return self._node.pools

    @property
    def iam(self):
        return self._node.iam

    @property
    def verifier(self):
        return self._node.s3.verifier

    @property
    def config(self):
        return getattr(self._node, "config", None)

    @property
    def healmgr(self):
        return getattr(self._node, "healmgr", None)

    @property
    def locker(self):
        return self._node.locker

    @property
    def notification(self):
        return self._node.notification

    @property
    def scanner(self):
        return getattr(self._node, "scanner", None)

    @property
    def tiering(self):
        return getattr(self._node, "tiering", None)

    @property
    def poolmgr(self):
        return getattr(self._node, "poolmgr", None)

    @property
    def bucket_meta(self):
        s3 = self._node.s3
        return s3.bucket_meta if s3 is not None else None

    @property
    def metrics(self):
        return getattr(self._node, "metrics", None)

    @property
    def trace(self):
        return getattr(self._node, "trace", None)

    @property
    def replication(self):
        return getattr(self._node, "replication", None)

    @property
    def site_repl(self):
        return getattr(self._node, "site_repl", None)

    @property
    def notifier(self):
        return getattr(self._node, "notifier", None)

    @property
    def kms(self):
        return getattr(self._node, "kms", None)

    @property
    def local_drives(self):
        # The selftest drive probe walks the PRODUCTION drive stacks
        # (metered/health-gated wrappers included), keyed by drive path.
        return self._node.local_drives

    @property
    def node_url(self):
        return self._node.url


def _default_set_count(n: int) -> int:
    """Largest set size in [4..16] dividing n; else n itself (small rigs).

    The reference computes symmetric set sizes from the ellipses pattern
    (endpoint-ellipses.go:68 possibleSetCounts); this is the same idea for
    explicit endpoint lists.
    """
    for size in range(16, 3, -1):
        if n % size == 0:
            return size
    return n
