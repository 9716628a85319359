"""Admin REST API: the management surface of one node.

Role of the reference's admin handlers (cmd/admin-handlers*.go, mounted at
/minio/admin/v3), mounted at /mtpu/admin/v1; every call is SigV4-signed and
authorized against the admin:* action namespace. The port serves: /info,
/service, /config, the users/groups/policies/service-accounts routes (IAM
only), /chaos, /heal, /perf, /perf/slow, the profiling routes, /toplocks,
/force-unlock, /inspect, /datausage, /quota, the pool lifecycle routes
(/pools/status, /pools/attach, /pools/decommission, /pools/rebalance) and
the remote tier routes (/tiers*); the fan-outs reach every peer through the
node's NotificationSys. Every other route of the JAX package's admin API is
registered and answers 501 NotImplemented naming the module it waits for
(ROADMAP.md, Queue A item 8).
"""

from __future__ import annotations

import asyncio
import json
import urllib.parse
from dataclasses import dataclass

from aiohttp import web

from ..control.iam import IAMSys
from ..utils import errors as oerr
from ..utils import fips as fips_mod
from .auth import SigV4Verifier
from .errors import S3Error

ADMIN_PREFIX = "/mtpu/admin/v1"

# The routes whose modules the port does not have yet, each with its module.
NOT_PORTED_ROUTES: tuple[tuple[str, str, str], ...] = (
    ("POST", "/site-replication/add", "control/site_replication.py"),
    ("GET", "/site-replication/info", "control/site_replication.py"),
    ("POST", "/site-replication/peer/join", "control/site_replication.py"),
    ("POST", "/site-replication/peer/bucket", "control/site_replication.py"),
    ("POST", "/site-replication/peer/meta", "control/site_replication.py"),
    ("POST", "/site-replication/peer/iam", "control/site_replication.py"),
    ("POST", "/site-replication/peer/install-replication", "control/site_replication.py"),
    ("GET", "/healthinfo", "control/health.py"),
    ("GET", "/bandwidth", "control/bandwidth.py"),
    ("GET", "/kms/status", "control/kms.py (the admin KMS routes)"),
    ("POST", "/update", "control/update.py"),
    ("GET", "/update", "control/update.py"),
    ("GET", "/kms/key/status", "control/kms.py (the admin KMS routes)"),
    ("GET", "/metrics", "control/metrics.py"),
    ("POST", "/speedtest", "control/selftest.py"),
    ("POST", "/speedtest/object", "control/selftest.py"),
    ("GET", "/speedtest/object", "control/selftest.py"),
    ("POST", "/speedtest/drive", "control/selftest.py"),
    ("GET", "/speedtest/drive", "control/selftest.py"),
    ("POST", "/speedtest/net", "control/selftest.py"),
    ("GET", "/speedtest/net", "control/selftest.py"),
    ("GET", "/timeseries", "control/metrics.py"),
    ("POST", "/flight/dump", "control/flight.py"),
    ("GET", "/flight", "control/flight.py"),
    ("GET", "/flight/{id}", "control/flight.py"),
    ("GET", "/trace", "api/streams.py"),
    ("POST", "/replication/target", "control/replication.py"),
    ("GET", "/replication/target", "control/replication.py"),
    ("DELETE", "/replication/target", "control/replication.py"),
    ("GET", "/replication/status", "control/replication.py"),
    ("POST", "/replication/resync", "control/replication.py"),
)


@dataclass
class AdminContext:
    layer: object
    iam: IAMSys
    verifier: SigV4Verifier
    config: object | None = None
    healmgr: object | None = None
    locker: object | None = None  # this node's LocalLocker (dist/locks.py)
    # The subsystems of later slices, read by the ported routes where the JAX
    # package's read them; None until those slices land.
    scanner: object | None = None  # DataScanner (usage in /info)
    metrics: object | None = None  # MetricsSys (memcache stats in /perf)
    notification: object | None = None  # peer fan-out
    site_repl: object | None = None  # SiteReplicationSys (site-replication.go)
    tiering: object | None = None  # TierConfigMgr (tier.go)
    bucket_meta: object | None = None  # BucketMetadataSys (quota config)
    poolmgr: object | None = None  # PoolManager (pool lifecycle admin)

def make_admin_app(ctx: AdminContext) -> web.Application:
    app = web.Application()

    async def authenticate(request: web.Request, body: bytes) -> str:
        headers = dict(request.headers)
        query = [(k, v) for k, v in request.rel_url.query.items()]
        path = urllib.parse.unquote(request.path_qs.split("?")[0])
        ak = await asyncio.to_thread(
            ctx.verifier.verify_signed, request.method, path, query, headers, body
        )
        if not ctx.iam.is_allowed(ak, "admin:*", "arn:aws:s3:::*"):
            raise S3Error("AccessDenied")
        return ak

    def handler(fn, stream: bool = False):
        async def wrapped(request: web.Request):
            if not getattr(ctx, "ready", True):
                return web.json_response({"Code": "ServerNotInitialized"}, status=503)
            body = await request.read()
            try:
                await authenticate(request, body)
                if stream:
                    return await fn(request, body)
                result = await asyncio.to_thread(fn, request, body)
                if isinstance(result, web.Response):
                    return result
                return web.json_response(result)
            except S3Error as e:
                return web.json_response(
                    {"Code": e.code, "Message": e.message}, status=e.api.http_status
                )
            except oerr.StorageError as e:
                return web.json_response(
                    {"Code": type(e).__name__, "Message": str(e)}, status=400
                )

        return wrapped

    # -- info / usage --------------------------------------------------------

    def h_info(request, body):
        drives = []
        online = offline = 0
        for p in ctx.layer.pools:
            for d in p.disks:
                if d is None:
                    offline += 1
                    drives.append({"state": "offline"})
                    continue
                try:
                    di = d.disk_info()
                    online += 1
                    drives.append(
                        {
                            "endpoint": di.endpoint,
                            "state": "ok",
                            "totalspace": di.total,
                            "availspace": di.free,
                            "uuid": di.disk_id,
                        }
                    )
                except oerr.DiskError:
                    offline += 1
                    drives.append({"endpoint": d.endpoint(), "state": "offline"})
        info = {
            "mode": "online",
            "deploymentID": getattr(ctx.layer.pools[0], "deployment_id", ""),
            "drives": drives,
            "drivesOnline": online,
            "drivesOffline": offline,
            "buckets": {"count": len(ctx.layer.list_buckets())},
            "fips": fips_mod.enabled(),
        }
        if ctx.scanner is not None:
            info["usage"] = ctx.scanner.usage.summary()
        if ctx.notification is not None:
            info["servers"] = ctx.notification.server_info_all()
        return info

    def h_datausage(request, body):
        if ctx.scanner is None:
            return {}
        return ctx.scanner.usage.summary()

    # -- bucket quota (Put/GetBucketQuotaConfigHandler,
    # cmd/admin-bucket-handlers.go:43,83) ------------------------------------

    def h_get_quota(request, body):
        bucket = request.rel_url.query.get("bucket", "")
        if not bucket or ctx.bucket_meta is None:
            raise S3Error("InvalidRequest")
        ctx.layer.get_bucket_info(bucket)
        q = ctx.bucket_meta.get(bucket).quota
        return {"quota": q, "quotatype": "hard" if q > 0 else ""}

    def h_set_quota(request, body):
        bucket = request.rel_url.query.get("bucket", "")
        if not bucket or ctx.bucket_meta is None:
            raise S3Error("InvalidRequest")
        ctx.layer.get_bucket_info(bucket)
        try:
            cfg = json.loads(body) if body else {}
            quota = int(cfg.get("quota", 0))
        except (ValueError, TypeError, AttributeError):  # non-object JSON too
            raise S3Error("InvalidRequest", "invalid quota config")
        if quota < 0 or cfg.get("quotatype", "hard") not in ("", "hard"):
            # FIFO quota is deprecated in the reference too; hard-only.
            raise S3Error("InvalidRequest", "only hard quotas are supported")
        # bucket_meta.update's on_change hook broadcasts the peer
        # invalidation (quota enforcement reads cached meta on every node).
        ctx.bucket_meta.update(bucket, quota=quota)
        return {"ok": True}

    # -- pool lifecycle (object/poolmgr.py; the reference's
    # admin pools attach / decommission / rebalance verbs) -------------------

    def _poolmgr():
        pm = getattr(ctx, "poolmgr", None)
        if pm is None:
            raise S3Error("NotImplemented", "pool lifecycle needs a running node")
        return pm

    def h_pools_status(request, body):
        return _poolmgr().status()

    def h_pools_attach(request, body):
        """POST {"endpoints": [...]} -- runtime attach-pool expansion."""
        doc = json.loads(body) if body else {}
        eps = doc.get("endpoints") or []
        if not eps or not isinstance(eps, list):
            raise S3Error("InvalidArgument", "endpoints list required")
        idx = _poolmgr().attach_endpoints([str(e) for e in eps])
        return {"pool": idx, "status": "active"}

    def h_pools_decommission(request, body):
        """POST {"pool": i, "wait": false} -- start (or resume) a drain."""
        doc = json.loads(body) if body else {}
        if "pool" not in doc:
            raise S3Error("InvalidArgument", "pool index required")
        tracker = _poolmgr().start_decommission(
            int(doc["pool"]), wait=bool(doc.get("wait", False))
        )
        from dataclasses import asdict as _asdict

        return {"drain": _asdict(tracker)}

    def h_pools_rebalance(request, body):
        """POST {"start": true, "threshold": 0.1} | {"start": false}."""
        doc = json.loads(body) if body else {}
        pm = _poolmgr()
        if doc.get("start", True):
            thr = doc.get("threshold")
            return pm.start_rebalance(None if thr is None else float(thr))
        return pm.stop_rebalance()

    # -- remote tiers (mc admin tier add/ls/rm; cmd/tier.go surface) ---------

    def h_tier_add(request, body):
        if ctx.tiering is None:
            raise S3Error("NotImplemented")
        from ..control.tiering import TierConfig

        ctx.tiering.add(TierConfig.from_dict(json.loads(body)))
        return {}

    def h_tier_list(request, body):
        if ctx.tiering is None:
            raise S3Error("NotImplemented")
        out = []
        for t in ctx.tiering.list():
            d = t.to_dict()
            d.pop("secret_key", None)
            out.append(d)
        return out

    def h_tier_remove(request, body):
        if ctx.tiering is None:
            raise S3Error("NotImplemented")
        ctx.tiering.remove(request.match_info["name"])
        return {}

    def h_tier_edit(request, body):
        if ctx.tiering is None:
            raise S3Error("NotImplemented")
        doc = json.loads(body)
        ctx.tiering.edit_creds(
            request.match_info["name"], doc["accessKey"], doc["secretKey"]
        )
        return {}

    def h_tier_stats(request, body):
        if ctx.tiering is None:
            raise S3Error("NotImplemented")
        return {
            "transitionedObjects": ctx.tiering.transitioned_objects,
            "transitionedBytes": ctx.tiering.transitioned_bytes,
            "journalBacklog": ctx.tiering.journal_backlog(),
        }

    # -- inspect raw storage files (InspectDataHandler,
    # cmd/admin-handlers.go:2198): the same file from EVERY drive, zipped,
    # so operators can diff xl.meta copies across the set. ------------------

    def h_inspect(request, body):
        import io
        import zipfile

        q = request.rel_url.query
        volume, fname = q.get("volume", ""), q.get("file", "")
        if not volume:
            raise S3Error("InvalidBucketName")
        if not fname:
            raise S3Error("InvalidRequest", "file is required")
        # Bounded per-copy read: inspect targets metadata-sized files
        # (xl.meta); a multi-GiB shard file must not be buffered whole from
        # 16 drives at once. Oversized copies are truncated and marked.
        CAP = 32 << 20
        buf = io.BytesIO()
        found = 0
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for pi, pool in enumerate(ctx.layer.pools):
                for di, d in enumerate(pool.disks):
                    if d is None:
                        continue
                    try:
                        size = d.stat_file(volume, fname)
                        raw = (
                            d.read_all(volume, fname)
                            if size <= CAP
                            else d.read_file(volume, fname, 0, CAP)
                        )
                    except oerr.StorageError:
                        continue
                    found += 1
                    name = f"pool{pi}/disk{di}/{volume}/{fname}"
                    if size > CAP:
                        name += ".truncated"
                    z.writestr(name, raw)
        if not found:
            raise S3Error("NoSuchKey", resource=f"/{volume}/{fname}")
        return web.Response(
            body=buf.getvalue(),
            content_type="application/zip",
            headers={"Content-Disposition": 'attachment; filename="inspect.zip"'},
        )

    # -- config --------------------------------------------------------------

    def h_get_config(request, body):
        if ctx.config is None:
            return {}
        return ctx.config.dump()

    def h_set_config(request, body):
        if ctx.config is None:
            raise S3Error("NotImplemented")
        doc = json.loads(body)
        dynamic = ctx.config.set(doc["subsys"], doc["key"], doc["value"])
        return {"dynamic": dynamic, "restart": not dynamic}

    # -- users / policies ----------------------------------------------------

    def h_list_users(request, body):
        return {
            ak: {"status": u.status, "policies": u.policies}
            for ak, u in ctx.iam.list_users().items()
        }

    def _reload_peers_iam():
        # Peers cache IAM in memory; a deleted/disabled identity must stop
        # authenticating NOW, not at their next restart.
        if ctx.notification is not None:
            ctx.notification.reload_iam_all()

    def _site_iam(kind, payload):
        if ctx.site_repl is not None and getattr(ctx.site_repl, "enabled", False):
            ctx.site_repl.on_iam(kind, payload)

    def h_add_user(request, body):
        doc = json.loads(body)
        ctx.iam.add_user(doc["accessKey"], doc["secretKey"], doc.get("policies", []))
        _reload_peers_iam()
        _site_iam("user", ctx.iam.users[doc["accessKey"]].to_dict())
        return {"ok": True}

    def h_remove_user(request, body):
        ctx.iam.remove_user(request.match_info["ak"])
        _reload_peers_iam()
        _site_iam("user-delete", {"access_key": request.match_info["ak"]})
        return {"ok": True}

    def h_user_status(request, body):
        doc = json.loads(body)
        ak = request.match_info["ak"]
        ctx.iam.set_user_status(ak, doc["status"])
        _reload_peers_iam()
        if ak in ctx.iam.users:
            _site_iam("user", ctx.iam.users[ak].to_dict())
        return {"ok": True}

    def h_user_policy(request, body):
        doc = json.loads(body)
        ctx.iam.attach_policy(request.match_info["ak"], doc["policies"])
        _reload_peers_iam()
        _site_iam("policy-mapping", {"access_key": request.match_info["ak"], "policies": doc["policies"]})
        return {"ok": True}

    def _str_list(doc, key: str) -> list[str]:
        # A bare string would iterate per-character into nonsense names
        # and "succeed" while denying everything.
        v = doc.get(key, [])
        if not isinstance(v, list) or not all(isinstance(x, str) for x in v):
            raise S3Error("InvalidRequest", f"{key} must be a list of strings")
        return v

    def h_groups_list(request, body):
        return {"groups": ctx.iam.list_groups()}

    def h_group_info(request, body):
        return ctx.iam.group_info(request.match_info["name"])

    def h_group_update(request, body):
        # UpdateGroupMembers (cmd/admin-handlers-users.go): members +
        # isRemove, creating the group on first add.
        doc = json.loads(body)
        ctx.iam.update_group_members(
            request.match_info["name"],
            _str_list(doc, "members"),
            remove=bool(doc.get("isRemove", False)),
        )
        _reload_peers_iam()
        _site_iam("group", ctx.iam.group_info(request.match_info["name"]))
        return {"ok": True}

    def h_group_delete(request, body):
        ctx.iam.remove_group(request.match_info["name"])
        _reload_peers_iam()
        _site_iam("group-delete", {"name": request.match_info["name"]})
        return {"ok": True}

    def h_group_status(request, body):
        doc = json.loads(body)
        ctx.iam.set_group_status(request.match_info["name"], doc["status"])
        _reload_peers_iam()
        _site_iam("group", ctx.iam.group_info(request.match_info["name"]))
        return {"ok": True}

    def h_group_policy(request, body):
        doc = json.loads(body)
        ctx.iam.attach_group_policy(request.match_info["name"], _str_list(doc, "policies"))
        _reload_peers_iam()
        _site_iam("group", ctx.iam.group_info(request.match_info["name"]))
        return {"ok": True}

    def h_ldap_policy(request, body):
        # Attach/detach policies for an LDAP user or group DN (the mc
        # `idp ldap policy attach` role); empty policies detaches.
        doc = json.loads(body)
        ctx.iam.set_ldap_policy(doc["dn"], doc.get("policies", []))
        _reload_peers_iam()
        _site_iam("ldap-policy-mapping", {"dn": doc["dn"], "policies": doc.get("policies", [])})
        return {"ok": True}

    def h_ldap_policy_list(request, body):
        return dict(ctx.iam.ldap_policy_map)

    def h_list_policies(request, body):
        from ..control import policy as policy_mod

        out = dict(ctx.iam.custom_policies)
        for name, doc in policy_mod.CANNED.items():
            out.setdefault(name, doc)
        return out

    def h_put_policy(request, body):
        doc = json.loads(body)
        from ..control import policy as policy_mod

        try:
            policy_mod.Policy.from_dict(doc).validate()
        except ValueError as e:
            raise S3Error("MalformedPolicy", str(e))
        ctx.iam.set_policy(request.match_info["name"], doc)
        _reload_peers_iam()
        _site_iam("policy", {"name": request.match_info["name"], "doc": doc})
        return {"ok": True}

    def h_delete_policy(request, body):
        ctx.iam.delete_policy(request.match_info["name"])
        _reload_peers_iam()
        _site_iam("policy-delete", {"name": request.match_info["name"]})
        return {"ok": True}

    def h_service_account(request, body):
        doc = json.loads(body) if body else {}
        parent = doc.get("parent") or ctx.iam.root.access_key
        creds = ctx.iam.new_service_account(parent, doc.get("policy"))
        _reload_peers_iam()
        if creds.access_key in ctx.iam.users:
            _site_iam("user", ctx.iam.users[creds.access_key].to_dict())
        return {"accessKey": creds.access_key, "secretKey": creds.secret_key}

    # -- heal ----------------------------------------------------------------

    def h_heal_start(request, body):
        if ctx.healmgr is None:
            raise S3Error("NotImplemented")
        doc = json.loads(body) if body else {}
        seq = ctx.healmgr.start_sequence(doc.get("bucket", ""), doc.get("prefix", ""))
        return {"healSequence": seq}

    def h_heal_status(request, body):
        st = ctx.healmgr.get_status(request.match_info["seq"]) if ctx.healmgr else None
        if st is None:
            raise S3Error("InvalidArgument", "unknown heal sequence")
        return {
            "id": st.seq_id,
            "path": st.path,
            "running": st.running,
            "scanned": st.scanned,
            "healed": st.healed,
            "failed": st.failed,
        }


    # -- chaos (fault injection; chaos/) -------------------------------------
    # POST arms a fault (body = FaultSpec JSON + optional "cluster": false),
    # GET lists armed faults per node, DELETE disarms one (?fault-id=) or
    # all. Arm/disarm apply locally first, then fan out to every peer so one
    # admin call breaks (and un-breaks) the whole cluster deterministically.

    def _chaos_registry():
        from ..chaos.faults import REGISTRY

        return REGISTRY

    def _crash_registry():
        from ..chaos.crash import REGISTRY

        return REGISTRY

    def h_chaos_arm(request, body):
        from ..chaos import crash as crash_mod
        from ..chaos.faults import FaultSpec

        doc = json.loads(body) if body else {}
        cluster = bool(doc.pop("cluster", True))
        try:
            # kind "crash" routes to the crash-point registry (process-death
            # schedules); every other kind is a FaultSpec (drive/net errors).
            if doc.get("kind") == crash_mod.CRASH_KIND:
                spec = crash_mod.CrashSpec.from_dict(doc)
                fid = _crash_registry().arm(spec)
            else:
                spec = FaultSpec.from_dict(doc)
                fid = _chaos_registry().arm(spec)
        except (ValueError, TypeError) as e:
            raise S3Error("InvalidArgument", str(e))
        if cluster and ctx.notification is not None:
            ctx.notification.chaos_all("arm", spec={**spec.to_dict(), "fault_id": fid})
        return {"fault_id": fid}

    def h_chaos_list(request, body):
        out = {"local": _chaos_registry().list() + _crash_registry().list()}
        for peer in _peer_clients():
            try:
                out[peer.url] = peer.chaos("list").get("faults", [])
            except oerr.StorageError:
                out[peer.url] = None  # unreachable peer is data, not a 500
        return out

    def h_chaos_disarm(request, body):
        fid = request.rel_url.query.get("fault-id", "")
        reg = _chaos_registry()
        creg = _crash_registry()
        if fid:
            removed = int(reg.disarm(fid)) + int(creg.disarm(fid))
        else:
            removed = reg.disarm_all() + creg.disarm_all()
        if request.rel_url.query.get("cluster", "") != "false" and ctx.notification is not None:
            ctx.notification.chaos_all("disarm", fault_id=fid)
        return {"removed": removed}


    # -- locks / service -----------------------------------------------------

    def h_top_locks(request, body):
        if ctx.locker is None:
            return []
        return ctx.locker.top_locks()

    def h_force_unlock(request, body):
        doc = json.loads(body)
        if ctx.locker is not None:
            ctx.locker.force_unlock(doc["resource"])
        return {"ok": True}

    def h_service(request, body):
        doc = json.loads(body) if body else {}
        action = doc.get("action", "")
        if action not in ("restart", "stop"):
            raise S3Error("InvalidArgument", "action must be restart|stop")
        # In-process server: acknowledge; the process manager does the rest
        # (the reference signals itself, cmd/service.go).
        return {"ok": True, "action": action}


    def h_perf(request, body):
        """Performance attribution surface (the always-on stage ledger):
        per-(layer, stage) p50/p95/p99 plus drive EWMAs and breaker state.
        ?cluster=1 merges every peer's ledger into one view; ?reset=1 zeroes
        the ledger, slow-capture ring, and drive EWMAs for a clean
        before/after measurement window (fanned out with ?cluster=1)."""
        from ..control.degrade import GLOBAL_DEGRADE
        from ..control.perf import GLOBAL_PERF, merge_snapshots, summarize

        q = request.rel_url.query
        reset = q.get("reset", "") in ("1", "true")
        cluster = q.get("cluster", "") in ("1", "true")

        from .. import runtime

        snap = GLOBAL_PERF.ledger.snapshot()
        out: dict = {
            "node": {"stages": summarize(snap)},
            "slow": GLOBAL_PERF.slow.stats(),
            # Degradation-ladder counters (hedges fired/won, breaker trips,
            # sheds): an SLO report needs these next to the latency tails.
            "degrade": GLOBAL_DEGRADE.snapshot(),
            # The device probe's verdict under the JAX keys: a node serves
            # only after an ok one (or on the codec its caller named).
            "probe": runtime.probe_summary(),
        }
        # Hot-read memory tier counters (absent when MTPU_MEMCACHE_MB=0):
        # the loadgen report's cache block reads these.
        mc = getattr(ctx.metrics, "memcache", None) if ctx.metrics else None
        if mc is not None:
            out["memcache"] = mc.stats()

        drives = {}
        for p in ctx.layer.pools:
            for d in p.disks:
                lat_fn = getattr(d, "api_latencies", None)
                ep_fn = getattr(d, "endpoint", None)
                if lat_fn is None or ep_fn is None:
                    continue
                try:
                    row: dict = {"api": lat_fn()}
                    state_fn = getattr(d, "breaker_state", None)
                    if state_fn is not None:
                        row["breaker"] = state_fn()
                    drives[ep_fn()] = row
                except oerr.StorageError:
                    continue
        out["drives"] = drives

        if cluster:
            snaps = [snap]
            peers = {}
            notification = ctx.notification
            for p in getattr(notification, "peers", ()) or ():
                try:
                    r = p.perf_snapshot(reset=reset, timeout=5.0)
                    snaps.append(r.get("snapshot", {}))
                    peers[p.url] = {"ok": True, "slow": r.get("slow", {})}
                except oerr.StorageError as e:
                    peers[p.url] = {"ok": False, "error": str(e)}
            out["cluster"] = {"stages": summarize(merge_snapshots(snaps))}
            out["peers"] = peers

        if reset:
            # Reset LAST: the response still reports the window being closed.
            GLOBAL_PERF.ledger.reset()
            GLOBAL_PERF.slow.reset()
            for p in ctx.layer.pools:
                for d in p.disks:
                    fn = getattr(d, "reset_api_latencies", None)
                    if fn is not None:
                        fn()
            out["reset"] = True
        return out

    def h_perf_slow(request, body):
        """Captured slow-request span trees, newest first, plus the knobs
        and eviction counters bounding the ring."""
        from ..control.perf import GLOBAL_PERF

        return {
            "stats": GLOBAL_PERF.slow.stats(),
            "traces": GLOBAL_PERF.slow.list(),
        }


    # -- profiling (admin-handlers.go:511-716 role): start broadcasts to
    # every peer; stop collects one dump per node -- plain text single-node,
    # a zip with per-node entries in a cluster. The profiler samples
    # sys._current_frames() from its own thread (control/profiler.py):
    # cProfile's per-thread hook enabled inside a request handler would
    # profile nothing but that handler's executor thread. -------------------

    _profiler: dict = {}

    def _peer_clients():
        n = getattr(ctx, "notification", None)
        return list(getattr(n, "peers", []) or [])

    def h_profile_start(request, body):
        from ..control.profiler import SamplingProfiler

        if "p" in _profiler:
            raise S3Error("InvalidArgument", "profiling already running")
        p = SamplingProfiler()
        p.start()
        _profiler["p"] = p
        started = ["local"]
        for peer in _peer_clients():
            try:
                if peer.profile_start().get("ok"):
                    started.append(peer.url)
            except oerr.StorageError:
                continue
        return {"ok": True, "nodes": started}

    def h_profile_stop(request, body):
        import io

        p = _profiler.pop("p", None)
        if p is None:
            raise S3Error("InvalidArgument", "profiling not running")
        p.stop()
        text = p.report()
        peers = _peer_clients()
        if not peers:
            return web.Response(text=text, content_type="text/plain")
        import zipfile

        zbuf = io.BytesIO()
        with zipfile.ZipFile(zbuf, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("local/profile.txt", text)
            for peer in peers:
                try:
                    peer_text = peer.profile_stop().get("text", "")
                except oerr.StorageError:
                    peer_text = ""
                safe = peer.url.replace("://", "_").replace(":", "_").replace("/", "_")
                z.writestr(f"{safe}/profile.txt", peer_text)
        return web.Response(
            body=zbuf.getvalue(),
            content_type="application/zip",
            headers={"Content-Disposition": 'attachment; filename="profiles.zip"'},
        )

    def h_profile(request, body):
        """Continuous profiling plane (control/profiler.py GLOBAL_PROFILER):
        rotating windows of role-aggregated stacks, the calibrated GIL-load
        gauge, and the copy ledger -- always on, no start/stop ceremony.

        ?collapsed=1 downloads flamegraph collapsed-stack text;
        ?summary=1 returns the compact report block (what loadgen embeds);
        ?cluster=1 merges every peer's windows/copy ledger into one view
        (gil_load stays per-node: GIL pressure doesn't sum across
        interpreters); ?top=N bounds stacks per window (default 40)."""
        from ..control.profiler import GLOBAL_PROFILER, merge_profiles

        q = request.rel_url.query
        try:
            top = int(q.get("top", "40"))
        except ValueError:
            raise S3Error("InvalidArgument", "top must be an integer")

        if q.get("collapsed", "") in ("1", "true"):
            s = GLOBAL_PROFILER.sampler
            return web.Response(
                text=s.collapsed(top=top) if s is not None else "",
                content_type="text/plain",
                headers={
                    "Content-Disposition": 'attachment; filename="profile.collapsed"'
                },
            )
        if q.get("summary", "") in ("1", "true"):
            return GLOBAL_PROFILER.summary()

        out = GLOBAL_PROFILER.snapshot(top=top)
        if q.get("cluster", "") in ("1", "true"):
            snaps = [out]
            peers = {}
            for peer in _peer_clients():
                try:
                    r = peer.profile_snapshot(timeout=10.0)
                    snaps.append(r.get("profile", {}))
                    peers[peer.url] = {"ok": True}
                except oerr.StorageError as e:
                    peers[peer.url] = {"ok": False, "error": str(e)}
            return {"node": out, "cluster": merge_profiles(snaps), "peers": peers}
        return out


    def not_ported(module: str):
        def h(request, body):
            raise S3Error(
                "NotImplemented",
                f"{request.method} {request.path} is not ported yet: it waits for {module}",
            )

        return h

    app.router.add_get("/info", handler(h_info))
    app.router.add_get("/config", handler(h_get_config))
    app.router.add_put("/config", handler(h_set_config))
    app.router.add_get("/users", handler(h_list_users))
    app.router.add_post("/users", handler(h_add_user))
    app.router.add_delete("/users/{ak}", handler(h_remove_user))
    app.router.add_put("/users/{ak}/status", handler(h_user_status))
    app.router.add_put("/users/{ak}/policy", handler(h_user_policy))
    app.router.add_get("/groups", handler(h_groups_list))
    app.router.add_get("/groups/{name}", handler(h_group_info))
    app.router.add_put("/groups/{name}", handler(h_group_update))
    app.router.add_delete("/groups/{name}", handler(h_group_delete))
    app.router.add_put("/groups/{name}/status", handler(h_group_status))
    app.router.add_put("/groups/{name}/policy", handler(h_group_policy))
    app.router.add_put("/idp/ldap/policy", handler(h_ldap_policy))
    app.router.add_get("/idp/ldap/policy", handler(h_ldap_policy_list))
    app.router.add_get("/policies", handler(h_list_policies))
    app.router.add_put("/policies/{name}", handler(h_put_policy))
    app.router.add_delete("/policies/{name}", handler(h_delete_policy))
    app.router.add_post("/service-accounts", handler(h_service_account))
    app.router.add_post("/chaos", handler(h_chaos_arm))
    app.router.add_get("/chaos", handler(h_chaos_list))
    app.router.add_delete("/chaos", handler(h_chaos_disarm))
    app.router.add_post("/heal", handler(h_heal_start))
    app.router.add_get("/heal/{seq}", handler(h_heal_status))
    app.router.add_post("/service", handler(h_service))
    app.router.add_get("/inspect", handler(h_inspect))
    app.router.add_get("/toplocks", handler(h_top_locks))
    app.router.add_post("/force-unlock", handler(h_force_unlock))
    app.router.add_get("/perf", handler(h_perf))
    app.router.add_get("/perf/slow", handler(h_perf_slow))
    app.router.add_post("/profile/start", handler(h_profile_start))
    app.router.add_post("/profile/stop", handler(h_profile_stop))
    app.router.add_get("/profile", handler(h_profile))
    app.router.add_get("/datausage", handler(h_datausage))
    app.router.add_get("/quota", handler(h_get_quota))
    app.router.add_put("/quota", handler(h_set_quota))
    app.router.add_get("/pools/status", handler(h_pools_status))
    app.router.add_post("/pools/attach", handler(h_pools_attach))
    app.router.add_post("/pools/decommission", handler(h_pools_decommission))
    app.router.add_post("/pools/rebalance", handler(h_pools_rebalance))
    app.router.add_post("/tiers", handler(h_tier_add))
    app.router.add_get("/tiers", handler(h_tier_list))
    app.router.add_delete("/tiers/{name}", handler(h_tier_remove))
    app.router.add_put("/tiers/{name}/creds", handler(h_tier_edit))
    app.router.add_get("/tiers/stats", handler(h_tier_stats))
    for method, path, module in NOT_PORTED_ROUTES:
        app.router.add_route(method, path, handler(not_ported(module)))
    return app
