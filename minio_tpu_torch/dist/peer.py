"""Peer REST: node-to-node control plane.

Role of the reference's peer REST v16 (cmd/peer-rest-{client,server}.go,
notification.go NotificationSys): config/IAM/bucket-metadata propagation,
health pings, lock listing, and admin fan-out. Data never rides this channel
-- it is DCN-latency-tolerant control traffic.
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
            # Refresh this node's notifier rules from the re-fetched
            # metadata (event config changed on a peer would otherwise
            # keep firing by this node's stale rule set).
            if bucket:
                node.refresh_bucket_notification(bucket)
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

    def h_speedtest(a):
        """Self-benchmark PUT+GET through the object layer
        (peer-rest-server.go:1137 selfSpeedtest)."""
        import os as _os
        import time as _time

        size = int(a.get("size", 1 << 20))
        count = int(a.get("count", 4))
        bucket = ".minio_tpu.sys"
        payload = _os.urandom(size)
        t0 = _time.perf_counter()
        for i in range(count):
            node.pools.pools[0].put_object(bucket, f"speedtest/obj-{i}", payload)
        put_t = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        for i in range(count):
            node.pools.pools[0].get_object(bucket, f"speedtest/obj-{i}")
        get_t = _time.perf_counter() - t0
        for i in range(count):
            try:
                node.pools.pools[0].delete_object(bucket, f"speedtest/obj-{i}")
            except errors.StorageError:
                pass
        return {
            "put_bytes_per_s": size * count / put_t if put_t else 0,
            "get_bytes_per_s": size * count / get_t if get_t else 0,
        }

    # Peer side of the live-cluster self-measurement plane
    # (control/selftest.py; the reference's peer-rest selfSpeedtest /
    # netperf verbs): the admin node fans a probe round out to every peer
    # so all nodes drive load AT THE SAME TIME.

    def h_selftest_object(a):
        """Run one object PUT+GET round locally at the requested
        concurrency (this node's contribution to a cluster speedtest)."""
        from ..control import selftest

        return selftest.run_object_round(
            node.pools,
            size=int(a.get("size", 1 << 20)),
            n_ops=int(a.get("ops", 8)),
            workers=int(a.get("workers", 4)),
            tag=node.url.replace("://", "-").replace(":", "-").replace("/", "-"),
        )

    def h_netperf_run(a):
        """Stream payloads from THIS node to all ITS peers: one row of the
        full-mesh bandwidth/latency matrix."""
        from ..control import selftest

        peers = list(getattr(node.notification, "peers", []) or [])
        return {
            "row": selftest.netperf_row(
                peers,
                size=int(a.get("size", 1 << 20)),
                rounds=int(a.get("rounds", 4)),
            )
        }

    def h_timeseries(a):
        """This node's raw ops/s ring snapshot; the admin
        /timeseries?cluster=1 endpoint merges rings second-by-second."""
        from ..control.perf import GLOBAL_PERF

        return {"timeseries": GLOBAL_PERF.timeseries.snapshot()}

    # Flight-recorder plane (control/flight.py): an incident detected on
    # any node broadcasts here so EVERY node freezes the same wall-clock
    # window -- one correlated black-box dump per incident, not N skewed
    # snapshots.

    def h_flight_capture(a):
        """Capture THIS node's bundle for the originator's incident (same
        t0/t1 cluster-wide). Idempotent per (incident, node); also arms the
        local cooldown so this node's own trigger won't re-open it."""
        from ..control.flight import GLOBAL_FLIGHT

        incident = a.get("incident", {}) or {}
        return {"id": GLOBAL_FLIGHT.capture(incident, node=node.url)}

    def h_flight_list(a):
        """This node's bundle metas + recorder counters; the admin
        /flight?cluster=1 endpoint merges peer lists."""
        from ..control.flight import GLOBAL_FLIGHT

        return {"bundles": GLOBAL_FLIGHT.list(), "stats": GLOBAL_FLIGHT.stats()}

    def h_flight_get(a):
        """One full bundle by id (or newest bundle of an incident id)."""
        from ..control.flight import GLOBAL_FLIGHT

        return {"bundle": GLOBAL_FLIGHT.get(str(a.get("id", "")))}

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

    # Streaming endpoints: this node's live event / trace records as NDJSON
    # (peer-rest-server.go:985 role) -- the serving node merges these into
    # its watcher responses so `mc watch` / `mc admin trace` see the whole
    # cluster, not one node.
    async def h_listen_stream(request: web.Request):
        if not check_token(request):
            return web.Response(status=403)
        notifier = getattr(node, "notifier", None)
        if notifier is None:
            return web.Response(status=501)
        import json as _json

        from ..api.streams import stream_hub_response

        return await stream_hub_response(request, notifier.listen_hub, _json.dumps)

    async def h_trace_stream(request: web.Request):
        if not check_token(request):
            return web.Response(status=403)
        trace = getattr(node, "trace", None)
        if trace is None:
            return web.Response(status=501)
        import json as _json

        from ..api.streams import stream_hub_response

        return await stream_hub_response(request, trace.hub, _json.dumps)

    for name, fn in {
        "ping": h_ping,
        "serverinfo": h_server_info,
        "reloadiam": h_reload_iam,
        "reloadbucketmeta": h_reload_bucket_meta,
        "memcacheinv": h_memcache_invalidate,
        "toplocks": h_top_locks,
        "poolsreload": h_pools_reload,
        "poolsstatus": h_pools_status,
        "speedtest": h_speedtest,
        "profilestart": h_profile_start,
        "profilestop": h_profile_stop,
        "profile": h_profile,
        "bandwidth": h_bandwidth,
        "metrics": h_node_metrics,
        "perf": h_perf,
        "chaos": h_chaos,
        "selftestobject": h_selftest_object,
        "netperfrun": h_netperf_run,
        "timeseries": h_timeseries,
        "flightcapture": h_flight_capture,
        "flightlist": h_flight_list,
        "flightget": h_flight_get,
    }.items():
        app.router.add_post(f"/{name}", handler(fn))
    app.router.add_post("/listen", h_listen_stream)
    app.router.add_post("/trace", h_trace_stream)

    async def h_netperf_sink(request: web.Request):
        """Netperf receive side: drain the raw payload, acknowledge its
        length. Raw body on purpose -- a msgpack round-trip would price the
        codec, not the link."""
        if not check_token(request):
            return web.Response(status=403)
        body = await request.read()
        return web.Response(
            body=msgpack.packb({"received": len(body)}, use_bin_type=True),
            content_type="application/x-msgpack",
        )

    app.router.add_post("/netperf", h_netperf_sink)
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

    def speedtest(self, size: int = 1 << 20, count: int = 4) -> dict:
        return self.client.call("/speedtest", {"size": size, "count": count}, timeout=120.0)

    def selftest_object(self, size: int, ops: int, workers: int) -> dict:
        """One object PUT+GET round on the peer (control/selftest.py)."""
        return self.client.call(
            "/selftestobject",
            {"size": size, "ops": ops, "workers": workers},
            timeout=120.0,
        )

    def netperf_run(self, size: int = 1 << 20, rounds: int = 4) -> dict:
        """Ask the peer to stream to ITS peers: its row of the mesh."""
        return self.client.call(
            "/netperfrun", {"size": size, "rounds": rounds}, timeout=120.0
        )

    def netperf_payload(self, payload) -> dict:
        """Send one raw payload to the peer's netperf sink."""
        return self.client.call("/netperf", body=payload, timeout=60.0)

    def timeseries_snapshot(self, timeout: float | None = None) -> dict:
        return self.client.call("/timeseries", {}, timeout=timeout) or {}

    def flight_capture(self, incident: dict, timeout: float | None = None) -> dict:
        """Ask the peer to capture ITS bundle for this incident's window."""
        return self.client.call(
            "/flightcapture", {"incident": incident}, timeout=timeout
        ) or {}

    def flight_list(self, timeout: float | None = None) -> dict:
        return self.client.call("/flightlist", {}, timeout=timeout) or {}

    def flight_get(self, bundle_id: str, timeout: float | None = None) -> dict:
        return self.client.call("/flightget", {"id": bundle_id}, timeout=timeout) or {}

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

    def listen_stream(self):
        """Live event stream from this peer (caller iterates lines + closes).
        No static timeout: the endpoint's DynamicTimeout tuner sizes the
        time-to-headers wait, and the peer's ~1s keep-alives hold the
        connection open far under the 5s tuner floor."""
        return self.client.call("/listen", {}, stream=True)

    def trace_stream(self):
        """Live trace stream from this peer."""
        return self.client.call("/trace", {}, stream=True)


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

    def flight_capture_all(self, incident: dict) -> None:
        """Incident broadcast (control/flight.py trigger/dump): every peer
        captures its bundle for the SAME wall-clock window, so the cluster
        yields one correlated dump per incident."""
        self._fanout(lambda p, t: p.flight_capture(incident, timeout=t))

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
