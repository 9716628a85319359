"""Load targets: the signed S3 op surface + the admin observability surface.

One S3Target drives any cluster that speaks the API -- the in-process
multi-node harness (cluster.py) or a live endpoint -- with sigv4-signed
requests round-robined across node URLs. Sessions are per-(thread, node):
workers never share a connection (requests.Session is not thread-safe and
sharing would serialize the very concurrency the scenario declares).

Error classes are what the SLO budget counts: transport failures and 5xx
burn budget; 4xx are split out by S3 code (a NoSuchKey during a racing
DELETE mix is workload shape, not server failure) and do NOT burn unless
the spec says so via `client_errors_burn`.

`requests` use here is deliberate and out of scope for the raw-transport
invariant: loadgen IS the external client; internode RPC discipline
(deadlines, chaos seams) does not apply to the traffic source.
"""

from __future__ import annotations

import threading
import urllib.parse
import xml.etree.ElementTree as ET
from typing import NamedTuple

import requests

from ..api.auth import Credentials, sign_request

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
ADMIN = "/mtpu/admin/v1"

_SELECT_XML = (
    b"<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
    b"<SelectObjectContentRequest>"
    b"<Expression>SELECT * FROM S3Object</Expression>"
    b"<ExpressionType>SQL</ExpressionType>"
    b"<InputSerialization><CSV/></InputSerialization>"
    b"<OutputSerialization><CSV/></OutputSerialization>"
    b"</SelectObjectContentRequest>"
)


class OpResult(NamedTuple):
    ok: bool
    error_class: str  # "" when ok; "transport" / "5xx" / "4xx:<Code>"
    nbytes: int       # payload bytes moved (PUT body / GET body / parts)


def _s3_code(resp: requests.Response) -> str:
    try:
        root = ET.fromstring(resp.content)
        code = root.find("Code")
        if code is None:
            code = root.find(f"{_NS}Code")
        if code is not None and code.text:
            return code.text
    except ET.ParseError:
        pass
    return str(resp.status_code)


def classify(resp: requests.Response) -> str:
    if resp.status_code < 400:
        return ""
    if resp.status_code >= 500:
        # Carry the S3 code: a shed (503 SlowDownRead) and an internal
        # error read very differently in a report, and both burn budget.
        return f"5xx:{_s3_code(resp)}"
    return f"4xx:{_s3_code(resp)}"


class S3Target:
    """Signed S3 ops against one or more node URLs of the same cluster."""

    def __init__(self, urls: list[str], access_key: str, secret_key: str,
                 region: str = "us-east-1", timeout_s: float = 30.0):
        if not urls:
            raise ValueError("S3Target needs at least one node URL")
        self.urls = [u.rstrip("/") for u in urls]
        self.creds = Credentials(access_key, secret_key)
        self.region = region
        self.timeout_s = timeout_s
        self._tls = threading.local()

    def _session(self, node: int) -> requests.Session:
        sessions = getattr(self._tls, "sessions", None)
        if sessions is None:
            sessions = self._tls.sessions = {}
        s = sessions.get(node)
        if s is None:
            s = sessions[node] = requests.Session()
        return s

    def close(self) -> None:
        sessions = getattr(self._tls, "sessions", None) or {}
        for s in sessions.values():
            s.close()
        self._tls.sessions = {}

    def request(self, method: str, path: str, query=None, body: bytes = b"",
                node: int = 0, stream: bool = False) -> requests.Response:
        query = query or []
        node = node % len(self.urls)
        base = self.urls[node]
        url = base + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers = {"host": urllib.parse.urlparse(base).netloc}
        headers = sign_request(
            self.creds, method, path, query, headers, body, region=self.region
        )
        headers.pop("host")
        return self._session(node).request(
            method, url, data=body, headers=headers,
            timeout=self.timeout_s, stream=stream,
        )

    # -- scenario ops ------------------------------------------------------

    def ensure_bucket(self, bucket: str) -> None:
        r = self.request("PUT", f"/{bucket}")
        if r.status_code not in (200, 409):
            raise RuntimeError(f"cannot create bucket {bucket}: {r.status_code} {r.text[:200]}")

    def put(self, bucket: str, key: str, body: bytes, node: int = 0) -> OpResult:
        try:
            r = self.request("PUT", f"/{bucket}/{key}", body=body, node=node)
        except requests.RequestException:
            return OpResult(False, "transport", 0)
        err = classify(r)
        return OpResult(not err, err, len(body) if not err else 0)

    def get(self, bucket: str, key: str, node: int = 0) -> OpResult:
        try:
            r = self.request("GET", f"/{bucket}/{key}", node=node)
            n = len(r.content)
        except requests.RequestException:
            return OpResult(False, "transport", 0)
        err = classify(r)
        return OpResult(not err, err, n if not err else 0)

    def delete(self, bucket: str, key: str, node: int = 0) -> OpResult:
        try:
            r = self.request("DELETE", f"/{bucket}/{key}", node=node)
        except requests.RequestException:
            return OpResult(False, "transport", 0)
        # S3 DELETE is idempotent: 204 on present AND absent keys.
        err = "" if r.status_code in (200, 204) else classify(r)
        return OpResult(not err, err, 0)

    def list(self, bucket: str, prefix: str, max_keys: int, node: int = 0) -> OpResult:
        q = [("list-type", "2"), ("prefix", prefix), ("max-keys", str(max_keys))]
        try:
            r = self.request("GET", f"/{bucket}", query=q, node=node)
            n = len(r.content)
        except requests.RequestException:
            return OpResult(False, "transport", 0)
        err = classify(r)
        return OpResult(not err, err, n if not err else 0)

    def multipart(self, bucket: str, key: str, part: bytes, parts: int,
                  node: int = 0) -> OpResult:
        """Full create -> upload N parts -> complete flow as ONE op: the
        latency an application sees for a large object is the whole dance."""
        path = f"/{bucket}/{key}"
        try:
            r = self.request("POST", path, query=[("uploads", "")], node=node)
            if classify(r):
                return OpResult(False, classify(r), 0)
            upload_el = ET.fromstring(r.content).find(f"{_NS}UploadId")
            if upload_el is None or not upload_el.text:
                return OpResult(False, "5xx", 0)
            uid = upload_el.text
            etags = []
            for n in range(1, parts + 1):
                r = self.request(
                    "PUT", path,
                    query=[("partNumber", str(n)), ("uploadId", uid)],
                    body=part, node=node,
                )
                if classify(r):
                    self.request("DELETE", path, query=[("uploadId", uid)], node=node)
                    return OpResult(False, classify(r), 0)
                etags.append(r.headers.get("ETag", "").strip('"'))
            complete = (
                "<CompleteMultipartUpload>"
                + "".join(
                    f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                    for n, e in enumerate(etags, 1)
                )
                + "</CompleteMultipartUpload>"
            ).encode()
            r = self.request("POST", path, query=[("uploadId", uid)],
                             body=complete, node=node)
        except (requests.RequestException, ET.ParseError):
            return OpResult(False, "transport", 0)
        err = classify(r)
        return OpResult(not err, err, len(part) * parts if not err else 0)

    def select(self, bucket: str, key: str, node: int = 0) -> OpResult:
        try:
            r = self.request(
                "POST", f"/{bucket}/{key}",
                query=[("select", ""), ("select-type", "2")],
                body=_SELECT_XML, node=node,
            )
            n = len(r.content)
        except requests.RequestException:
            return OpResult(False, "transport", 0)
        err = classify(r)
        return OpResult(not err, err, n if not err else 0)


# -- admin observability/chaos surfaces ---------------------------------------


class InProcessAdmin:
    """Admin surface when the cluster shares this process: read the global
    singletons directly. The process-wide perf ledger IS the cluster-merged
    view here (every node records into it), so asking one node for
    ?cluster=1 would sum the same ledger once per node."""

    probe_cached = False

    def __init__(self, cluster=None):
        # Optional InProcessCluster handle: memcache counters are per-node
        # objects (not global singletons), so the hot-read report needs the
        # nodes to sum them over. Tests that don't care pass nothing.
        self.cluster = cluster

    def stage_breakdown(self) -> dict:
        from ..control.perf import GLOBAL_PERF, summarize

        return summarize(GLOBAL_PERF.ledger.snapshot())

    def cache_stats(self) -> dict:
        """Cluster-summed memcache counters ({} when no node runs the tier)."""
        nodes = getattr(self.cluster, "nodes", None) or ()
        stats = [
            n.memcache.stats()
            for n in nodes
            if getattr(n, "memcache", None) is not None
        ]
        if not stats:
            return {}
        out = {k: sum(s[k] for s in stats) for k in stats[0] if k != "hit_ratio"}
        lookups = out["hits"] + out["misses"]
        out["hit_ratio"] = round(out["hits"] / lookups, 4) if lookups else 0.0
        return out

    def degrade(self) -> dict:
        from ..control.degrade import GLOBAL_DEGRADE

        return GLOBAL_DEGRADE.snapshot()

    def reset_perf(self) -> None:
        from ..control.perf import GLOBAL_PERF

        GLOBAL_PERF.ledger.reset()
        GLOBAL_PERF.slow.reset()

    def arm_fault(self, fault: dict) -> str:
        from ..chaos import crash as crash_mod
        from ..chaos.faults import REGISTRY, FaultSpec

        if fault.get("kind") == crash_mod.CRASH_KIND:
            return crash_mod.REGISTRY.arm(crash_mod.CrashSpec.from_dict(fault))
        return REGISTRY.arm(FaultSpec.from_dict(fault))

    def disarm_fault(self, fault_id: str) -> None:
        from ..chaos import crash as crash_mod
        from ..chaos.faults import REGISTRY

        if not REGISTRY.disarm(fault_id):
            crash_mod.REGISTRY.disarm(fault_id)

    def start_profile(self) -> bool:
        from ..control.profiler import GLOBAL_PROFILER

        return GLOBAL_PROFILER.ensure_started()

    def profile_summary(self) -> dict:
        from ..control.profiler import GLOBAL_PROFILER

        return GLOBAL_PROFILER.summary()

    # -- flight recorder ----------------------------------------------------

    def flight_reset(self) -> None:
        from ..control.flight import GLOBAL_FLIGHT

        GLOBAL_FLIGHT.reset()

    def flight_bundles(self) -> list:
        """Bundle metas for EVERY node: the process-wide recorder stores one
        bundle per node tag, so its list already is the cluster view."""
        from ..control.flight import GLOBAL_FLIGHT

        return GLOBAL_FLIGHT.list()

    # -- pool lifecycle ----------------------------------------------------

    def _poolmgr(self):
        for n in getattr(self.cluster, "nodes", None) or ():
            pm = getattr(n, "poolmgr", None)
            if pm is not None:
                return pm
        raise RuntimeError("no pool manager in the in-process cluster")

    def pool_admin(self, op: dict) -> dict:
        """One-shot pool lifecycle op: {"op": "decommission", "pool": i} /
        {"op": "attach", "endpoints": [...]} / {"op": "rebalance", ...}."""
        from dataclasses import asdict

        pm = self._poolmgr()
        kind = op.get("op")
        if kind == "decommission":
            tr = pm.start_decommission(
                int(op["pool"]), wait=bool(op.get("wait", False))
            )
            return {"drain": asdict(tr)}
        if kind == "attach":
            idx = pm.attach_endpoints([str(e) for e in op.get("endpoints", [])])
            return {"pool": idx}
        if kind == "rebalance":
            if op.get("start", True):
                return {"rebalance": pm.start_rebalance(op.get("threshold"))}
            return {"rebalance": pm.stop_rebalance()}
        raise RuntimeError(f"unknown pool admin op {kind!r}")

    def pool_status(self) -> dict:
        return self._poolmgr().status()


class EndpointAdmin:
    """Admin surface over the wire (live-endpoint mode): the signed admin
    REST endpoints, with ?cluster=1 doing the peer merge server-side."""

    def __init__(self, target: S3Target):
        self.target = target
        self.probe_cached = False

    def _get_json(self, path: str, query=None) -> dict:
        r = self.target.request("GET", path, query=query or [])
        if r.status_code != 200:
            return {}
        try:
            return r.json()
        except ValueError:
            return {}

    def stage_breakdown(self) -> dict:
        doc = self._get_json(ADMIN + "/perf", query=[("cluster", "1")])
        cluster = doc.get("cluster", {})
        if isinstance(cluster, dict) and cluster.get("stages"):
            return cluster["stages"]
        return doc.get("node", {}).get("stages", {})

    def degrade(self) -> dict:
        return self._get_json(ADMIN + "/perf").get("degrade", {})

    def cache_stats(self) -> dict:
        return self._get_json(ADMIN + "/perf").get("memcache", {})

    def reset_perf(self) -> None:
        self.target.request("GET", ADMIN + "/perf",
                            query=[("cluster", "1"), ("reset", "1")])

    def arm_fault(self, fault: dict) -> str:
        import json as _json

        r = self.target.request("POST", ADMIN + "/chaos",
                                body=_json.dumps(fault).encode())
        if r.status_code != 200:
            raise RuntimeError(f"chaos arm failed: {r.status_code} {r.text[:200]}")
        return r.json().get("fault_id", "")

    def disarm_fault(self, fault_id: str) -> None:
        self.target.request("DELETE", ADMIN + "/chaos",
                            query=[("fault-id", fault_id)])

    def start_profile(self) -> bool:
        # The plane is armed server-side at node build; asking for the
        # summary confirms it's live (armed=False in the block otherwise).
        return bool(self._get_json(ADMIN + "/profile").get("armed"))

    def profile_summary(self) -> dict:
        return self._get_json(ADMIN + "/profile", query=[("summary", "1")])

    # -- flight recorder ----------------------------------------------------

    def flight_bundles(self) -> list:
        """Cluster-merged bundle metas (GET /flight?cluster=1 flattened)."""
        doc = self._get_json(ADMIN + "/flight", query=[("cluster", "1")])
        out = list(doc.get("bundles") or [])
        for row in (doc.get("peers") or {}).values():
            if isinstance(row, dict) and row.get("ok"):
                out.extend(row.get("bundles") or [])
        return out

    # -- pool lifecycle ----------------------------------------------------

    def pool_admin(self, op: dict) -> dict:
        import json as _json

        paths = {
            "decommission": "/pools/decommission",
            "attach": "/pools/attach",
            "rebalance": "/pools/rebalance",
        }
        kind = op.get("op")
        path = paths.get(str(kind))
        if path is None:
            raise RuntimeError(f"unknown pool admin op {kind!r}")
        body = {k: v for k, v in op.items() if k != "op"}
        r = self.target.request("POST", ADMIN + path,
                                body=_json.dumps(body).encode())
        if r.status_code != 200:
            raise RuntimeError(
                f"pool admin {kind} failed: {r.status_code} {r.text[:200]}"
            )
        return r.json()

    def pool_status(self) -> dict:
        return self._get_json(ADMIN + "/pools/status")
