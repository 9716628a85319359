"""Peer REST: node-to-node control plane.

Role of the reference's peer REST v16 (cmd/peer-rest-{client,server}.go,
notification.go NotificationSys): config/IAM/bucket-metadata propagation,
health pings, lock listing, and admin fan-out. Data never rides this channel
-- it is DCN-latency-tolerant control traffic.

The routes whose modules the port does not have yet answer 501 naming the
module, from NOT_PORTED_PEER_ROUTES (ROADMAP.md, Queue A item 8), as
api/admin.py's NOT_PORTED_ROUTES do, and PeerClient has no calls for them.
"""

from __future__ import annotations

import hmac
import time

import msgpack
from aiohttp import web

from ..control import tracing
from ..utils import deadline, errors
from .transport import ERROR_HEADER, TOKEN_HEADER, RestClient

PEER_PREFIX = "/mtpu/peer/v1"
START_TIME = time.time()

# The peer routes whose modules the port does not have yet, each with its
# module (ROADMAP.md, Queue A item 8).
NOT_PORTED_PEER_ROUTES: tuple[tuple[str, str], ...] = (
    ("speedtest", "control/selftest.py"),
    ("selftestobject", "control/selftest.py"),
    ("netperfrun", "control/selftest.py"),
    ("netperf", "control/selftest.py"),
    ("flightcapture", "control/flight.py"),
    ("flightlist", "control/flight.py"),
    ("flightget", "control/flight.py"),
    ("listen", "control/events.py and api/streams.py"),
    ("trace", "control/events.py and api/streams.py"),
)


def make_peer_app(node, token: str) -> web.Application:
    app = web.Application()

    def check_token(request: web.Request) -> bool:
        # Constant-time: equality timing must not leak matched prefixes.
        return hmac.compare_digest(request.headers.get(TOKEN_HEADER, ""), token)

    def handler(fn):
        async def wrapped(request: web.Request):
            import asyncio

            if not check_token(request):
                return web.Response(status=403)
            body = await request.read()
            a = msgpack.unpackb(body, raw=False) if body else {}
            try:
                with tracing.bind_header(request.headers.get(tracing.TRACE_HEADER)), \
                        deadline.bind_header(request.headers.get(deadline.DEADLINE_HEADER)):
                    result = await asyncio.to_thread(fn, a)
                return web.Response(
                    body=msgpack.packb(result, use_bin_type=True),
                    content_type="application/x-msgpack",
                )
            except Exception as e:  # noqa: BLE001
                return web.Response(
                    status=500, headers={ERROR_HEADER: type(e).__name__}, text=str(e)
                )

        return wrapped

    def h_ping(a):
        return {"pong": True, "node": node.url}

    def h_server_info(a):
        drives = []
        for d in node.local_drives.values():
            try:
                di = d.disk_info()
                drives.append(
                    {"path": di.mount_path, "total": di.total, "free": di.free, "ok": True}
                )
            except errors.DiskError:
                drives.append({"path": d.root, "ok": False})
        return {
            "node": node.url,
            "uptime": time.time() - START_TIME,
            "drives": drives,
            "version": "0.1.0",
        }

    def h_reload_iam(a):
        if node.iam is not None:
            node.iam.load()
        return {"ok": True}

    def h_reload_bucket_meta(a):
        bucket = a.get("bucket", "")
        if node.s3 is not None:
            node.s3.bucket_meta.invalidate(bucket)
            # Refreshing this node's notifier rules from the re-fetched
            # metadata waits for the event notifier (control/events.py,
            # ROADMAP.md Queue A item 8.3).
        # Also drop the object layer's bucket-EXISTENCE cache: a peer that
        # deleted the bucket must not leave this node serving PUTs into the
        # removed namespace for the cache TTL.
        if node.pools is not None:
            node.pools.invalidate_bucket_cache(bucket)
        return {"ok": True}

    def h_memcache_invalidate(a):
        """Per-object memcache invalidation (the hot-read tier's coherence
        channel): a peer that just acked a PUT/DELETE/COPY drops OUR cached
        entries before its client sees the ack. Empty object = whole bucket."""
        mc = getattr(node, "memcache", None)
        if mc is not None:
            bucket = a.get("bucket", "")
            obj = a.get("object", "")
            if obj:
                mc.invalidate_object(bucket, obj)
            elif bucket:
                mc.invalidate_bucket(bucket)
        return {"ok": True}

    def h_top_locks(a):
        return node.locker.top_locks()

    def h_pools_reload(a):
        """Pool-config epoch fanout target: re-read the persisted pool set
        (object/poolmgr.py). The attaching/draining node bumps the epoch,
        persists, then broadcasts this verb so every node agrees on the
        pool set before new writes can land on it."""
        reload_fn = getattr(node, "reload_pools", None)
        if reload_fn is None:
            return {"ok": False}
        return {"ok": True, "applied": bool(reload_fn())}

    def h_pools_status(a):
        """This node's view of the pool set (epoch + per-pool gauges)."""
        pm = getattr(node, "poolmgr", None)
        if pm is None:
            return {}
        return pm.status()

    def h_timeseries(a):
        """This node's raw ops/s ring snapshot; the admin
        /timeseries?cluster=1 endpoint merges rings second-by-second."""
        from ..control.perf import GLOBAL_PERF

        return {"timeseries": GLOBAL_PERF.timeseries.snapshot()}

    # Per-node profiling (peer side of the admin start/download broadcast,
    # cmd/admin-handlers.go:511-716: every node profiles itself with a
    # whole-process sampler; the admin node collects one dump per node).
    def h_profile_start(a):
        from ..control.profiler import SamplingProfiler

        old = getattr(node, "_peer_profiler", None)
        if old is not None:
            # A lost stop call (peer timeout, admin crash) must not wedge
            # profiling forever: discard the orphan and start fresh.
            old.stop()
        p = SamplingProfiler()
        p.start()
        node._peer_profiler = p
        return {"ok": True}

    def h_profile_stop(a):
        p = getattr(node, "_peer_profiler", None)
        node._peer_profiler = None
        if p is None:
            return {"text": ""}
        p.stop()
        return {"text": p.report()}

    def h_profile(a):
        """This node's continuous-profiling snapshot (rotating stack windows,
        GIL load, copy ledger): the admin /profile?cluster=1 endpoint merges
        these into the cluster view (merge_profiles)."""
        from ..control.profiler import GLOBAL_PROFILER

        return {
            "profile": GLOBAL_PROFILER.snapshot(top=int(a.get("top", 40)))
        }

    def h_bandwidth(a):
        """This node's replication bandwidth monitor (merged cluster-wide by
        the admin endpoint; each node throttles its own replica traffic)."""
        repl = getattr(node, "replication", None)
        if repl is None:
            return {}
        return repl.bandwidth.report(a.get("bucket", ""))

    def h_node_metrics(a):
        """This node's Prometheus exposition text; the serving node merges
        peer texts into /minio/v2/metrics/cluster with a server label."""
        metrics = getattr(node, "metrics", None)
        if metrics is None:
            return {"text": ""}
        return {"text": metrics.render_node()}

    def h_perf(a):
        """This node's stage-ledger snapshot (and optionally a reset): the
        admin /perf?cluster=1 endpoint merges these into the cluster view."""
        from ..control.perf import GLOBAL_PERF

        if a.get("reset"):
            GLOBAL_PERF.ledger.reset()
            GLOBAL_PERF.slow.reset()
        return {"snapshot": GLOBAL_PERF.ledger.snapshot(),
                "slow": GLOBAL_PERF.slow.stats()}

    def h_chaos(a):
        """Peer side of the admin chaos fanout: arm/disarm/list faults in
        THIS node's process-global registries (chaos/faults.py for error
        injection, chaos/crash.py for kind="crash" process-death points).
        The arming admin node passes the fault_id through so a later
        cluster-wide disarm removes the same fault everywhere."""
        from ..chaos import crash as crash_mod
        from ..chaos.faults import REGISTRY, FaultSpec

        op = a.get("op", "list")
        if op == "arm":
            spec = a.get("spec", {})
            if spec.get("kind") == crash_mod.CRASH_KIND:
                fid = crash_mod.REGISTRY.arm(crash_mod.CrashSpec.from_dict(spec))
            else:
                fid = REGISTRY.arm(FaultSpec.from_dict(spec))
            return {"fault_id": fid}
        if op == "disarm":
            fid = a.get("fault_id", "")
            if fid:
                removed = int(REGISTRY.disarm(fid)) + int(crash_mod.REGISTRY.disarm(fid))
            else:
                removed = REGISTRY.disarm_all() + crash_mod.REGISTRY.disarm_all()
            return {"removed": int(removed)}
        return {"faults": REGISTRY.list() + crash_mod.REGISTRY.list()}

    for name, fn in {
        "ping": h_ping,
        "serverinfo": h_server_info,
        "reloadiam": h_reload_iam,
        "reloadbucketmeta": h_reload_bucket_meta,
        "memcacheinv": h_memcache_invalidate,
        "toplocks": h_top_locks,
        "poolsreload": h_pools_reload,
        "poolsstatus": h_pools_status,
        "profilestart": h_profile_start,
        "profilestop": h_profile_stop,
        "profile": h_profile,
        "bandwidth": h_bandwidth,
        "metrics": h_node_metrics,
        "perf": h_perf,
        "chaos": h_chaos,
        "timeseries": h_timeseries,
    }.items():
        app.router.add_post(f"/{name}", handler(fn))

    def not_ported(name: str, module: str):
        async def h(request: web.Request):
            if not check_token(request):
                return web.Response(status=403)
            return web.Response(
                status=501,
                headers={ERROR_HEADER: "NotImplementedError"},
                text=f"/{name} is not ported yet: it waits for {module}",
            )

        return h

    for name, module in NOT_PORTED_PEER_ROUTES:
        app.router.add_post(f"/{name}", not_ported(name, module))
    return app


class PeerClient:
    def __init__(self, node_url: str, token: str):
        self.url = node_url
        self.client = RestClient(node_url.rstrip("/") + PEER_PREFIX, token, timeout=10.0)

    def ping(self) -> bool:
        try:
            r = self.client.call("/ping", {})
            return bool(r and r.get("pong"))
        except errors.StorageError:
            return False

    def server_info(self) -> dict:
        return self.client.call("/serverinfo", {})

    def reload_iam(self, timeout: float | None = None) -> None:
        self.client.call("/reloadiam", {}, timeout=timeout)

    def reload_bucket_meta(
        self, bucket: str = "", timeout: float | None = None
    ) -> None:
        self.client.call("/reloadbucketmeta", {"bucket": bucket}, timeout=timeout)

    def invalidate_memcache(
        self, bucket: str, object_name: str = "", timeout: float | None = None
    ) -> None:
        self.client.call(
            "/memcacheinv", {"bucket": bucket, "object": object_name},
            timeout=timeout,
        )

    def pools_reload(self, timeout: float | None = None) -> bool:
        r = self.client.call("/poolsreload", {}, timeout=timeout)
        return bool(r and r.get("applied"))

    def pools_status(self, timeout: float | None = None) -> dict:
        return self.client.call("/poolsstatus", {}, timeout=timeout) or {}

    def node_metrics(self, timeout: float | None = None) -> str:
        r = self.client.call("/metrics", {}, timeout=timeout)
        return r.get("text", "") if r else ""

    def perf_snapshot(self, reset: bool = False, timeout: float | None = None) -> dict:
        return self.client.call("/perf", {"reset": bool(reset)}, timeout=timeout) or {}

    def top_locks(self) -> list:
        return self.client.call("/toplocks", {})

    def timeseries_snapshot(self, timeout: float | None = None) -> dict:
        return self.client.call("/timeseries", {}, timeout=timeout) or {}

    def bandwidth(self, bucket: str = "") -> dict:
        return self.client.call("/bandwidth", {"bucket": bucket})

    def chaos(self, op: str, spec: dict | None = None, fault_id: str = "",
              timeout: float | None = None) -> dict:
        return self.client.call(
            "/chaos",
            {"op": op, "spec": spec or {}, "fault_id": fault_id},
            timeout=timeout,
        )

    def profile_start(self) -> dict:
        return self.client.call("/profilestart", {})

    def profile_stop(self) -> dict:
        return self.client.call("/profilestop", {}, timeout=60.0)

    def profile_snapshot(self, top: int = 40, timeout: float | None = None) -> dict:
        return self.client.call("/profile", {"top": top}, timeout=timeout) or {}


class NotificationSys:
    """Fan-out helper to all peers (cmd/notification.go:50 role)."""

    def __init__(self, peers: list[PeerClient]):
        self.peers = peers

    # Peers whose health flag says offline still get ONE quick attempt
    # with this timeout: the flag can be stale (transient blip already
    # healed), and a skipped invalidation is a silent consistency hole.
    OFFLINE_ATTEMPT_TIMEOUT = 2.0

    def _fanout(self, call) -> None:
        """Best-effort broadcast to EVERY peer. Peers believed online use
        the endpoint's tuned timeout; peers marked offline are still tried
        with a short one so a stale is_online() flag can't drop the
        invalidation, while a genuinely dead peer costs at most ~2s of a
        concurrent worker, not the caller's whole request."""
        if not self.peers:
            return

        def one(p):
            timeout = None if p.client.is_online() else self.OFFLINE_ATTEMPT_TIMEOUT
            try:
                call(p, timeout)
            except errors.StorageError:
                pass

        if len(self.peers) == 1:
            one(self.peers[0])
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, len(self.peers))) as pool:
            list(pool.map(one, self.peers))

    def reload_iam_all(self) -> None:
        self._fanout(lambda p, t: p.reload_iam(timeout=t))

    def chaos_all(self, op: str, spec: dict | None = None, fault_id: str = "") -> None:
        """Cluster-wide fault arm/disarm (the admin /chaos handlers call
        this after applying locally)."""
        self._fanout(lambda p, t: p.chaos(op, spec=spec, fault_id=fault_id, timeout=t))

    def reload_bucket_meta_all(self, bucket: str = "") -> None:
        self._fanout(lambda p, t: p.reload_bucket_meta(bucket, timeout=t))

    def pools_reload_all(self) -> None:
        """Pool-config epoch broadcast: every peer re-reads the persisted
        pool set. Called under the attach/decommission transition so the
        cluster agrees on pool membership before writes route to it."""
        self._fanout(lambda p, t: p.pools_reload(timeout=t))

    def invalidate_memcache_all(self, bucket: str, object_name: str = "") -> None:
        """Synchronous cross-node memcache invalidation: the writing node
        calls this BEFORE acking its client, so a subsequent read on any
        peer misses (or revalidates) instead of serving the old bytes."""
        self._fanout(lambda p, t: p.invalidate_memcache(bucket, object_name, timeout=t))

    def server_info_all(self) -> list[dict]:
        out = []
        for p in self.peers:
            try:
                out.append(p.server_info())
            except errors.StorageError:
                out.append({"node": p.url, "offline": True})
        return out
