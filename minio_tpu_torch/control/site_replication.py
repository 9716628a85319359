"""Site replication: IAM + bucket metadata + object data across clusters.

Role of the reference's SiteReplicationSys (cmd/site-replication.go:172,
AddPeerClusters :256): an operator joins N independent clusters into one
replicated federation. After the join, every cluster mirrors:
  * bucket create/delete (with object-lock enablement),
  * the full bucket metadata blob (policy, versioning, tagging, lifecycle,
    encryption, object-lock, cors, notification, quota),
  * IAM items (policies, users, service accounts, policy attachments),
  * object data, by auto-installing bucket-replication targets + rules
    between every pair of sites (the reference does exactly this —
    site replication is layered ON the bucket-replication engine).

Control traffic rides signed admin REST between sites (the reference's
SRPeer* admin RPCs); data rides the existing replication workers, whose
REPLICA status marking prevents ping-pong loops. Peer-applied control
changes go through the local subsystems directly (not the S3 handler
hooks), so they don't re-fan-out either.

A copy of the JAX package's control/site_replication.py: the same
state.json bytes and the same peer admin calls, so port sites and JAX sites
join one federation.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass

from ..utils import errors
from .sanitizer import san_lock, san_rlock

STATE_PATH = "site-replication/state.json"
ADMIN_PREFIX = "/mtpu/admin/v1"


@dataclass
class PeerSite:
    """One member cluster of the replicated federation."""

    name: str
    endpoint: str
    access_key: str
    secret_key: str
    deployment_id: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PeerSite":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


class SiteClient:
    """Signed S3 + admin client for one peer site."""

    def __init__(self, site: PeerSite):
        import requests

        from ..api.auth import Credentials, sign_request

        self._sign = sign_request
        self.site = site
        self.creds = Credentials(site.access_key, site.secret_key)
        self.endpoint = site.endpoint.rstrip("/")
        self.host = urllib.parse.urlparse(self.endpoint).netloc
        self.session = requests.Session()

    def request(self, method, path, query=None, body=b"", headers=None, timeout=15):
        query = query or []
        headers = dict(headers or {})
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers["host"] = self.host
        signed = self._sign(self.creds, method, path, query, headers, body)
        signed.pop("host", None)
        return self.session.request(method, url, data=body, headers=signed, timeout=timeout)

    def admin(self, method: str, subpath: str, payload: dict | None = None):
        body = json.dumps(payload).encode() if payload is not None else b""
        return self.request(method, f"{ADMIN_PREFIX}{subpath}", body=body)

    def online(self) -> bool:
        try:
            return self.admin("GET", "/info").status_code == 200
        except Exception:
            return False


class SiteReplicationSys:
    """Per-node site replication state + fan-out engine."""

    def __init__(self, layer, bucket_meta, iam, targets, replication, store,
                 self_endpoint: str = "", notifier=None, retry_interval: float = 5.0):
        self.layer = layer
        self.bucket_meta = bucket_meta
        self.iam = iam
        self.targets = targets  # BucketTargetSys
        self.replication = replication  # ReplicationSys
        self.store = store  # ConfigStore
        self.notifier = notifier  # EventNotifier, refreshed on meta apply
        self.self_endpoint = self_endpoint.rstrip("/")
        self.self_name = ""
        self.sites: list[PeerSite] = []
        self.last_errors: dict[str, str] = {}
        self.retry_interval = retry_interval
        self._client_cache: dict[str, SiteClient] = {}
        # Failed control fan-outs: (site_name, subpath, payload, attempts).
        # Object data has the replication workers' retry list; control
        # changes get the same at-least-once treatment here.
        self._pending: deque[tuple[str, str, dict, int]] = deque()
        self._pending_lock = san_lock("SiteReplicationSys._pending_lock")
        self._retry_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = san_lock("SiteReplicationSys._lock")
        self.load()

    # -- state ---------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self.sites)

    def load(self) -> None:
        try:
            raw = self.store.get(STATE_PATH) if self.store is not None else None
        except errors.StorageError:
            return  # degraded-quorum boot: start un-federated, don't crash
        if not raw:
            return
        try:
            d = json.loads(raw.decode())
            self.self_name = d.get("self_name", "")
            self.sites = [PeerSite.from_dict(s) for s in d.get("sites", [])]
        except (ValueError, KeyError):
            pass

    def _persist(self) -> None:
        if self.store is None:
            return
        self.store.put(
            STATE_PATH,
            json.dumps(
                {"self_name": self.self_name, "sites": [s.to_dict() for s in self.sites]}
            ).encode(),
        )

    def peers(self) -> list[PeerSite]:
        return [s for s in self.sites if s.name != self.self_name]

    def _client(self, site: PeerSite) -> SiteClient:
        c = self._client_cache.get(site.name)
        if c is None or c.site is not site:
            c = SiteClient(site)
            self._client_cache[site.name] = c
        return c

    def _clients(self) -> list[SiteClient]:
        return [self._client(s) for s in self.peers()]

    def _call(self, client: SiteClient, subpath: str, payload: dict,
              retry: bool = True) -> bool:
        """One control fan-out. Local state is already committed by the
        caller; a peer failure must never fail the client request — it is
        recorded and retried in the background (at-least-once; peer applies
        are idempotent full-state writes)."""
        name = client.site.name
        try:
            r = client.admin("POST", subpath, payload)
            if r.status_code == 200:
                self.last_errors.pop(name, None)
                return True
            err = f"{subpath}: HTTP {r.status_code}"
        except Exception as e:  # noqa: BLE001 - network errors must not surface
            err = f"{subpath}: {type(e).__name__}: {e}"
        self.last_errors[name] = err
        if retry:
            with self._pending_lock:
                self._pending.append((name, subpath, payload, 0))
            self._ensure_retry_thread()
        return False

    def _ensure_retry_thread(self) -> None:
        if self._retry_thread is None or not self._retry_thread.is_alive():
            self._retry_thread = threading.Thread(
                target=self._retry_loop, daemon=True, name="site-repl-retry"
            )
            self._retry_thread.start()

    def _retry_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.retry_interval)
            with self._pending_lock:
                batch = list(self._pending)
                self._pending.clear()
            for name, subpath, payload, attempts in batch:
                site = next((s for s in self.peers() if s.name == name), None)
                if site is None:
                    continue  # left the federation
                payload = self._refresh_payload(subpath, payload)
                if payload is None:
                    continue  # superseded (e.g. bucket/user since deleted)
                try:
                    r = self._client(site).admin("POST", subpath, payload)
                    ok = r.status_code == 200
                except Exception:  # noqa: BLE001
                    ok = False
                if ok:
                    self.last_errors.pop(name, None)
                elif attempts + 1 < 120:  # ~10 min at the default interval
                    with self._pending_lock:
                        self._pending.append((name, subpath, payload, attempts + 1))
                else:
                    self.last_errors[name] = f"{subpath}: gave up after {attempts + 1} tries"

    def _refresh_payload(self, subpath: str, payload: dict) -> dict | None:
        """Re-derive a queued fan-out from CURRENT local state so a stale
        failure never overwrites a newer successful write on the peer.
        Returns None when the change was superseded and should be dropped."""
        try:
            if subpath.endswith("/peer/meta"):
                bucket = payload["bucket"]
                try:
                    meta = self.bucket_meta.get(bucket)
                except errors.StorageError:
                    return None  # bucket gone; the delete fan-out covers it
                return {"bucket": bucket, "meta": _meta_fields(meta)}
            if subpath.endswith("/peer/iam"):
                kind = payload["kind"]
                if kind in ("user",):
                    ak = payload["payload"]["accessKey"]
                    ident = self.iam.users.get(ak)
                    if ident is None:
                        return {"kind": "user-delete", "payload": {"access_key": ak}}
                    return {"kind": "user", "payload": ident.to_dict()}
                if kind == "policy":
                    name = payload["payload"]["name"]
                    doc = self.iam.custom_policies.get(name)
                    if doc is None:
                        return {"kind": "policy-delete", "payload": {"name": name}}
                    return {"kind": "policy", "payload": {"name": name, "doc": doc}}
                return payload  # deletes/mappings replay as-is (idempotent)
            if subpath.endswith("/peer/bucket") and payload.get("op") == "make":
                try:
                    self.layer.get_bucket_info(payload["bucket"])
                except errors.StorageError:
                    return None  # created then deleted before the retry landed
                return payload
        except (KeyError, TypeError):
            return None  # malformed queue entry; drop
        return payload

    def pending_fanout(self) -> int:
        with self._pending_lock:
            return len(self._pending)

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the retry loop; returns whether it ended. A second call does
        not wait again (as ReplicationSys.close)."""
        again = self._stop.is_set()
        self._stop.set()
        t = self._retry_thread
        if t is not None:
            # The loop wakes from its retry_interval wait on _stop; a batch
            # mid-flight finishes its current peer call, hence the bound.
            t.join(0.0 if again else timeout)
            return not t.is_alive()
        return True

    # -- operator entry point (AddPeerClusters, site-replication.go:256) -----

    def add_peer_clusters(self, sites: list[dict]) -> dict:
        """Join this cluster with the given sites. Called on ONE site; it
        pushes the membership to every peer, then seeds peers with this
        cluster's current buckets, metadata, and IAM."""
        parsed = [PeerSite.from_dict(s) for s in sites]
        if len(parsed) < 2:
            raise errors.InvalidArgument(msg="need at least two sites")
        names = [s.name for s in parsed]
        if len(set(names)) != len(names):
            raise errors.InvalidArgument(msg="duplicate site names")
        me = next(
            (s for s in parsed if s.endpoint.rstrip("/") == self.self_endpoint), None
        )
        if me is None:
            raise errors.InvalidArgument(
                msg=f"own endpoint {self.self_endpoint!r} not in site list"
            )
        # Preflight BEFORE any state is committed anywhere: every peer must
        # be reachable with the given credentials and hold no buckets (the
        # reference refuses to join non-empty peers — only the initiating
        # site may carry existing state, which it then seeds to the rest).
        peer_sites = [s for s in parsed if s.name != me.name]
        for site in peer_sites:
            c = SiteClient(site)
            try:
                r = c.admin("GET", "/info")
            except Exception as e:  # noqa: BLE001
                raise errors.InvalidArgument(
                    msg=f"site {site.name} unreachable at {site.endpoint}: {e}"
                )
            if r.status_code != 200:
                raise errors.InvalidArgument(
                    msg=f"site {site.name}: credentials rejected (HTTP {r.status_code})"
                )
            n_buckets = (r.json().get("buckets") or {}).get("count", 0)
            if n_buckets:
                raise errors.InvalidArgument(
                    msg=f"site {site.name} is not empty ({n_buckets} buckets); "
                    "only the initiating site may hold existing data"
                )

        with self._lock:
            self.self_name = me.name
            self.sites = parsed
            self._client_cache.clear()
            self._persist()

        # Tell every peer about the membership (SRPeerJoin). Failures here
        # are retried like any other control fan-out (peers passed preflight
        # a moment ago, so a failure is transient).
        for c in self._clients():
            self._call(
                c,
                "/site-replication/peer/join",
                {"self_name": c.site.name, "sites": [s.to_dict() for s in parsed]},
            )

        # Seed peers with existing local state, then wire data replication.
        synced = {"buckets": 0, "policies": 0, "users": 0}
        for b in self.layer.list_buckets():
            self._sync_bucket_everywhere(b.name)
            synced["buckets"] += 1
        for name, doc in self.iam.custom_policies.items():
            self.on_iam("policy", {"name": name, "doc": doc})
            synced["policies"] += 1
        for ak, ident in self.iam.list_users().items():
            self.on_iam("user", ident.to_dict())
            synced["users"] += 1
        # Groups too: users carry group NAMES, but the definitions
        # (members/status/policies) live in iam.groups — without this pass
        # a joined site denies every group-granted request.
        synced["groups"] = 0
        for gname in self.iam.list_groups():
            self.on_iam("group", self.iam.group_info(gname))
            synced["groups"] += 1
        return {"status": "success", "synced": synced, "sites": names}

    def _sync_bucket_everywhere(self, bucket: str) -> None:
        """Make the bucket + metadata exist on all peers and install
        two-directional data replication for it."""
        # Versioning first, locally, BEFORE the meta snapshot leaves: the
        # peers must never observe versioning="" after their make-bucket
        # enabled it, or seed replicas land unversioned.
        meta = self.bucket_meta.get(bucket)
        if not meta.versioning_enabled():
            meta.versioning = "Enabled"
            self.bucket_meta.save(meta)
        for c in self._clients():
            self._call(c, "/site-replication/peer/bucket", {"op": "make", "bucket": bucket})
            self._call(
                c, "/site-replication/peer/meta", {"bucket": bucket, "meta": _meta_fields(meta)}
            )
        self.install_bucket_replication(bucket)
        # Objects put before the join flow via existing-object resync (the
        # reference triggers the same on AddPeerClusters).
        if self.replication is not None:
            try:
                self.replication.resync(bucket)
            except errors.StorageError:
                pass
        # Peers must also replicate back to us and to each other: ask each
        # peer to (re)install its own outbound replication for this bucket.
        for c in self._clients():
            self._call(c, "/site-replication/peer/install-replication", {"bucket": bucket})

    # -- data-plane wiring ----------------------------------------------------

    def install_bucket_replication(self, bucket: str) -> None:
        """Install one replication target + rule per peer for this bucket
        (the reference synthesizes the same from site config). Re-running is
        idempotent: set_target keeps the ARN for a known endpoint+bucket."""
        if not self.enabled:
            return
        # Site replication needs versioned buckets on every side.
        meta = self.bucket_meta.get(bucket)
        if not meta.versioning_enabled():
            meta.versioning = "Enabled"
            self.bucket_meta.save(meta)
        rules = []
        for i, peer in enumerate(self.peers()):
            arn = self.targets.set_target(
                bucket,
                endpoint=peer.endpoint,
                target_bucket=bucket,
                access_key=peer.access_key,
                secret_key=peer.secret_key,
            )
            rules.append(
                f"<Rule><ID>site-repl-{peer.name}</ID><Status>Enabled</Status>"
                f"<Priority>{100 + i}</Priority><Filter><Prefix></Prefix></Filter>"
                f"<Destination><Bucket>{arn}</Bucket></Destination>"
                "<DeleteMarkerReplication><Status>Enabled</Status></DeleteMarkerReplication>"
                "<DeleteReplication><Status>Enabled</Status></DeleteReplication>"
                "<ExistingObjectReplication><Status>Enabled</Status></ExistingObjectReplication>"
                "</Rule>"
            )
        # Preserve user-configured rules (e.g. replication to an external
        # cluster): only rules this subsystem owns (ID site-repl-*) are
        # regenerated; everything else is carried over verbatim.
        rules.extend(_foreign_rules(self.bucket_meta.get(bucket).replication_xml))
        xml = (
            '<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            + "".join(rules)
            + "</ReplicationConfiguration>"
        )
        self.bucket_meta.update(bucket, replication_xml=xml)

    # -- local-change hooks (called from S3/admin handlers) -------------------

    def on_bucket_make(self, bucket: str) -> None:
        if not self.enabled:
            return
        self._sync_bucket_everywhere(bucket)

    def on_bucket_delete(self, bucket: str) -> None:
        if not self.enabled:
            return
        for c in self._clients():
            self._call(c, "/site-replication/peer/bucket", {"op": "delete", "bucket": bucket})

    def on_bucket_meta(self, bucket: str) -> None:
        if not self.enabled:
            return
        try:
            meta = self.bucket_meta.get(bucket)
        except errors.StorageError:
            return
        for c in self._clients():
            self._call(
                c, "/site-replication/peer/meta", {"bucket": bucket, "meta": _meta_fields(meta)}
            )

    def on_iam(self, kind: str, payload: dict) -> None:
        if not self.enabled:
            return
        for c in self._clients():
            self._call(c, "/site-replication/peer/iam", {"kind": kind, "payload": payload})

    # -- peer-side application (SRPeer* handlers) ------------------------------

    def apply_join(self, self_name: str, sites: list[dict]) -> None:
        with self._lock:
            self.self_name = self_name
            self.sites = [PeerSite.from_dict(s) for s in sites]
            self._client_cache.clear()
            self._persist()

    def apply_bucket(self, op: str, bucket: str) -> None:
        if op == "make":
            try:
                self.layer.make_bucket(bucket)
            except errors.BucketExists:
                pass
            meta = self.bucket_meta.get(bucket)
            if not meta.versioning_enabled():
                meta.versioning = "Enabled"
                self.bucket_meta.save(meta)
        elif op == "delete":
            try:
                self.layer.delete_bucket(bucket)
                self.bucket_meta.delete(bucket)
            except errors.BucketNotFound:
                pass  # already gone: idempotent success
            # Anything else (e.g. BucketNotEmpty while replication lags)
            # propagates: the initiator's retry loop re-sends until the
            # replicated deletes land and this succeeds.
        else:
            raise errors.InvalidArgument(msg=f"bad bucket op {op!r}")

    def apply_meta(self, bucket: str, fields: dict) -> None:
        allowed = {k for k in fields if k in _REPLICATED_META_FIELDS}
        self.bucket_meta.update(bucket, **{k: fields[k] for k in allowed})
        if self.notifier is not None and "notification_xml" in fields:
            self.notifier.set_bucket_rules_from_xml(
                bucket, (fields["notification_xml"] or "").encode()
            )

    def apply_iam(self, kind: str, payload: dict) -> None:
        if kind == "policy":
            self.iam.set_policy(payload["name"], payload["doc"])
        elif kind == "policy-delete":
            self.iam.delete_policy(payload["name"])
        elif kind == "user":
            from .iam import UserIdentity

            ident = UserIdentity.from_dict(payload)
            self.iam.users[ident.credentials.access_key] = ident
            self.iam._persist()
        elif kind == "user-delete":
            try:
                self.iam.remove_user(payload["access_key"])
            except errors.StorageError:
                pass  # already gone: at-least-once replay must be idempotent
        elif kind == "policy-mapping":
            self.iam.attach_policy(payload["access_key"], payload["policies"])
        elif kind == "ldap-policy-mapping":
            self.iam.set_ldap_policy(payload["dn"], payload.get("policies", []))
        elif kind == "group":
            # Whole-group snapshot replace (members/status/policies).
            name = payload["name"]
            with self.iam._mutating(), self.iam._lock:
                self.iam.groups[name] = {
                    "members": list(payload.get("members", [])),
                    "status": payload.get("status", "enabled"),
                    "policies": list(payload.get("policies", [])),
                }
                for ak, ident in self.iam.users.items():
                    member = ak in payload.get("members", [])
                    if member and name not in ident.groups:
                        ident.groups.append(name)
                    if not member and name in ident.groups:
                        ident.groups.remove(name)
        elif kind == "group-delete":
            with self.iam._mutating(), self.iam._lock:
                self.iam.groups.pop(payload["name"], None)
                for ident in self.iam.users.values():
                    if payload["name"] in ident.groups:
                        ident.groups.remove(payload["name"])
        else:
            raise errors.InvalidArgument(msg=f"bad iam kind {kind!r}")

    def apply_install_replication(self, bucket: str) -> None:
        self.install_bucket_replication(bucket)

    # -- status ---------------------------------------------------------------

    def info(self) -> dict:
        out = {
            "enabled": self.enabled,
            "name": self.self_name,
            "sites": [],
            "last_errors": dict(self.last_errors),
        }
        def probe(site):
            try:
                return (
                    self._client(site).request(
                        "GET", f"{ADMIN_PREFIX}/info", timeout=2
                    ).status_code
                    == 200
                )
            except Exception:  # noqa: BLE001
                return False

        peers = [s for s in self.sites if s.name != self.self_name]
        with ThreadPoolExecutor(max_workers=max(1, len(peers) or 1)) as pool:
            alive = dict(zip([p.name for p in peers], pool.map(probe, peers)))
        for s in self.sites:
            entry = {"name": s.name, "endpoint": s.endpoint, "self": s.name == self.self_name}
            if s.name != self.self_name:
                entry["online"] = alive.get(s.name, False)
            out["sites"].append(entry)
        return out


_REPLICATED_META_FIELDS = (
    "versioning policy_json tagging lifecycle_xml encryption_xml "
    "object_lock_xml cors_xml notification_xml quota"
).split()


def _meta_fields(meta) -> dict:
    return {k: getattr(meta, k) for k in _REPLICATED_META_FIELDS}


def _foreign_rules(existing_xml: str) -> list[str]:
    """Serialize rules NOT owned by site replication from an existing
    ReplicationConfiguration (user rules survive reinstalls)."""
    import xml.etree.ElementTree as ET

    if not existing_xml:
        return []
    text = existing_xml.replace(
        'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"', ""
    )
    try:
        root = ET.fromstring(text)
    except ET.ParseError:
        return []
    out = []
    for r in root.findall("Rule"):
        rid = r.findtext("ID") or ""
        if not rid.startswith("site-repl-"):
            out.append(ET.tostring(r, encoding="unicode"))
    return out
