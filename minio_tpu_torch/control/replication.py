"""Bucket replication: async per-object replication to remote S3 targets.

Role of the reference's bucket replication stack:
- cmd/bucket-targets.go (:449, BucketTargetSys) — per-bucket registry of
  remote S3 targets, each minted an ARN used by replication rules.
- cmd/bucket-replication.go (:1851) — ReplicationPool (:1283) with worker
  and MRF-retry channels (:1302-1364); objects matching an Enabled rule are
  marked PENDING at write time and replicated asynchronously; status moves
  PENDING -> COMPLETED/FAILED in object metadata; replicas carry REPLICA
  status; delete-marker replication and existing-object resync.
- cmd/bucket-replication-utils.go (:603) — rule matching / status types.

A copy of the JAX package's control/replication.py: the same target
registry bytes in bucket metadata, rules, statuses and X-Minio-Source-*
headers, so a port source replicates to a JAX target and back. Replication
itself is host-side signed HTTP; the bytes it ships come from a full
erasure GET on the source (every row's digest verified on the card, and a
reconstruct when the source is degraded), and the target's PUT encodes them
there again.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from ..object.types import GetObjectOptions
from ..utils import errors
from .sanitizer import san_lock, san_rlock

# Replication status values (bucket-replication-utils.go replication.StatusType).
PENDING = "PENDING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
REPLICA = "REPLICA"

# Internal metadata keys (the reference stores these in xl.meta's internal
# metadata: ReservedMetadataPrefix + "replication-status" etc).
META_REPL_STATUS = "x-internal-replication-status"
META_REPLICA_STATUS = "x-internal-replica-status"

# Headers a source cluster sends with replica writes (the reference uses
# X-Minio-Source-* internal headers so targets preserve version identity).
HDR_SOURCE_REPL = "x-minio-source-replication-request"
HDR_SOURCE_VID = "x-minio-source-version-id"
HDR_SOURCE_MTIME = "x-minio-source-mtime"

ARN_PREFIX = "arn:minio:replication:"


@dataclass
class BucketTarget:
    """One remote replication target (madmin.BucketTarget analogue)."""

    arn: str
    source_bucket: str
    endpoint: str
    target_bucket: str
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    bandwidth: int = 0  # replica bytes/s cap, 0 = unlimited (BandwidthLimit)

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict) -> "BucketTarget":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


class TargetClient:
    """Minimal SigV4-signing S3 client for replica traffic (the reference
    uses minio-go; this speaks the same wire subset over requests)."""

    def __init__(self, target: BucketTarget):
        import requests

        from ..api.auth import Credentials, sign_request

        self._sign = sign_request
        self.target = target
        self.creds = Credentials(target.access_key, target.secret_key)
        self.endpoint = target.endpoint.rstrip("/")
        self.host = urllib.parse.urlparse(self.endpoint).netloc
        self.session = requests.Session()

    def _request(self, method, path, query=None, body=b"", headers=None):
        query = query or []
        headers = dict(headers or {})
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers["host"] = self.host
        signed = self._sign(
            self.creds, method, path, query, headers, body, region=self.target.region
        )
        signed.pop("host", None)
        return self.session.request(method, url, data=body, headers=signed, timeout=30)

    def online(self) -> bool:
        try:
            r = self._request("HEAD", f"/{self.target.target_bucket}")
            return r.status_code in (200, 301, 307, 403)
        except Exception:
            return False

    def put_object(self, key: str, data: bytes, headers: dict[str, str]):
        return self._request(
            "PUT", f"/{self.target.target_bucket}/{key}", body=data, headers=headers
        )

    def delete_object(
        self, key: str, version_id: str = "", headers: dict[str, str] | None = None
    ):
        query = [("versionId", version_id)] if version_id else []
        return self._request(
            "DELETE",
            f"/{self.target.target_bucket}/{key}",
            query=query,
            headers=headers or {},
        )


class BucketTargetSys:
    """Per-bucket remote-target registry persisted in bucket metadata
    (bucket-targets.go BucketTargetSys; targets live in bucket-metadata.bin).
    Target secret keys are sealed with the cluster KMS before they touch
    disk (the reference stores bucket-targets config KMS-encrypted)."""

    def __init__(self, bucket_meta, kms=None):
        self.bucket_meta = bucket_meta
        self.kms = kms
        self._clients: dict[str, TargetClient] = {}
        self._lock = san_lock("BucketTargetSys._lock")

    def _seal(self, bucket: str, secret: str) -> str:
        from .crypto import seal_secret

        return seal_secret(self.kms, f"bucket-targets/{bucket}", secret)

    def _unseal(self, bucket: str, stored: str) -> str:
        from .crypto import unseal_secret

        return unseal_secret(self.kms, f"bucket-targets/{bucket}", stored)

    def _load(self, bucket: str) -> list[BucketTarget]:
        raw = getattr(self.bucket_meta.get(bucket), "targets_json", "") or "[]"
        out = []
        for d in json.loads(raw):
            t = BucketTarget.from_dict(d)
            t.secret_key = self._unseal(bucket, t.secret_key)
            out.append(t)
        return out

    def _store(self, bucket: str, targets: list[BucketTarget]) -> None:
        docs = []
        for t in targets:
            d = t.to_dict()
            d["secret_key"] = self._seal(bucket, d["secret_key"])
            docs.append(d)
        self.bucket_meta.update(bucket, targets_json=json.dumps(docs))

    def set_target(
        self,
        bucket: str,
        endpoint: str,
        target_bucket: str,
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
        bandwidth: int = 0,
    ) -> str:
        # Re-registering the same endpoint+bucket (e.g. credential rotation)
        # keeps the existing ARN so replication rules referencing it stay
        # valid (bucket-targets.go updates in place for same target).
        targets = self._load(bucket)
        arn = ""
        kept = []
        for x in targets:
            if x.target_bucket == target_bucket and x.endpoint == endpoint:
                arn = x.arn
            else:
                kept.append(x)
        if not arn:
            arn = f"{ARN_PREFIX}{region}:{uuid.uuid4()}:{target_bucket}"
        t = BucketTarget(
            arn=arn,
            source_bucket=bucket,
            endpoint=endpoint,
            target_bucket=target_bucket,
            access_key=access_key,
            secret_key=secret_key,
            region=region,
            bandwidth=bandwidth,
        )
        kept.append(t)
        self._store(bucket, kept)
        with self._lock:
            self._clients.pop(arn, None)  # drop any client with stale creds
        return arn

    def list_targets(self, bucket: str) -> list[BucketTarget]:
        return self._load(bucket)

    def bandwidth_of(self, bucket: str, arn: str) -> int:
        """Configured replica bandwidth cap for one target, WITHOUT
        unsealing secrets -- this sits on the replication worker hot path
        (per replica PUT), where a KMS decrypt per object would be both
        slow and a new failure mode."""
        raw = getattr(self.bucket_meta.get(bucket), "targets_json", "") or "[]"
        try:
            for d in json.loads(raw):
                if d.get("arn") == arn:
                    return int(d.get("bandwidth", 0) or 0)
        except (ValueError, TypeError):
            pass
        return 0

    def remove_target(self, bucket: str, arn: str) -> None:
        self._store(bucket, [t for t in self._load(bucket) if t.arn != arn])
        with self._lock:
            self._clients.pop(arn, None)

    def client(self, bucket: str, arn: str) -> TargetClient | None:
        with self._lock:
            c = self._clients.get(arn)
            if c is not None:
                return c
        for t in self._load(bucket):
            if t.arn == arn:
                c = TargetClient(t)
                with self._lock:
                    self._clients[arn] = c
                return c
        return None


@dataclass
class ReplicationRule:
    """One <Rule> of an S3 ReplicationConfiguration
    (internal/bucket/replication/rule.go)."""

    id: str = ""
    status: str = "Enabled"
    priority: int = 0
    prefix: str = ""
    dest_arn: str = ""
    delete_marker_replication: bool = False
    delete_replication: bool = False
    existing_object_replication: bool = False

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"

    def matches(self, object_name: str) -> bool:
        return self.enabled and object_name.startswith(self.prefix)


def parse_replication_xml(raw: str | bytes) -> list[ReplicationRule]:
    """Parse ReplicationConfiguration XML -> rules, highest priority first
    (internal/bucket/replication/replication.go ParseConfig)."""
    if not raw:
        return []
    text = raw.decode() if isinstance(raw, bytes) else raw
    # Strip namespace for uniform lookups.
    text = text.replace('xmlns="http://s3.amazonaws.com/doc/2006-03-01/"', "")
    root = ET.fromstring(text)
    rules = []
    for r in root.findall("Rule"):
        def _txt(el, path, default=""):
            node = el.find(path)
            return node.text or default if node is not None and node.text else default

        prefix = _txt(r, "Filter/Prefix") or _txt(r, "Filter/And/Prefix") or _txt(r, "Prefix")
        rules.append(
            ReplicationRule(
                id=_txt(r, "ID"),
                status=_txt(r, "Status", "Enabled"),
                priority=int(_txt(r, "Priority", "0") or 0),
                prefix=prefix,
                dest_arn=_txt(r, "Destination/Bucket"),
                delete_marker_replication=_txt(r, "DeleteMarkerReplication/Status") == "Enabled",
                delete_replication=_txt(r, "DeleteReplication/Status") == "Enabled",
                existing_object_replication=_txt(r, "ExistingObjectReplication/Status")
                == "Enabled",
            )
        )
    rules.sort(key=lambda x: -x.priority)
    return rules


@dataclass
class ReplTask:
    bucket: str
    object_name: str
    version_id: str = ""
    op: str = "put"  # put | delete
    delete_marker: bool = False
    attempts: int = 0
    # True for resync-enqueued tasks: only destinations whose rule enables
    # ExistingObjectReplication receive them (per-target gating, matching
    # the reference's existing-object semantics).
    existing: bool = False
    # Earliest monotonic time the retry loop may re-dispatch this task
    # (exponential backoff so a peer outage doesn't burn the attempt budget).
    next_at: float = 0.0


class ReplStats:
    """Thread-safe counters (request threads and workers both mutate)."""

    def __init__(self):
        self._lock = san_lock("ReplStats._lock")
        self.completed = 0
        self.failed = 0
        self.replicated_bytes = 0

    def add(self, completed: int = 0, failed: int = 0, replicated_bytes: int = 0) -> None:
        with self._lock:
            self.completed += completed
            self.failed += failed
            self.replicated_bytes += replicated_bytes


class ReplicationSys:
    """The ReplicationPool analogue (bucket-replication.go:1283): a worker
    pool draining a task queue, plus an MRF-style retry list for failures."""

    def __init__(self, layer, bucket_meta, targets: BucketTargetSys, kms=None, workers: int = 4):
        from .bandwidth import BandwidthMonitor

        self.layer = layer
        self.bucket_meta = bucket_meta
        self.targets = targets
        self.kms = kms
        self.stats = ReplStats()
        # Per-(bucket, target) replica bandwidth limits + observed rates
        # (internal/bucket/bandwidth role; limits from BucketTarget.bandwidth).
        self.bandwidth = BandwidthMonitor()
        self._q: queue.Queue[ReplTask | None] = queue.Queue(maxsize=100_000)
        self._retry: list[ReplTask] = []
        self._retry_lock = san_lock("ReplicationSys._retry_lock")
        self._rule_cache: dict[str, tuple[str, list[ReplicationRule]]] = {}
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"repl-{i}")
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()
        self._retry_thread = threading.Thread(
            target=self._retry_loop, daemon=True, name="repl-retry"
        )
        self._retry_thread.start()

    # -- config ---------------------------------------------------------------

    def rules(self, bucket: str) -> list[ReplicationRule]:
        try:
            raw = self.bucket_meta.get(bucket).replication_xml
        except errors.StorageError:
            return []
        # Memoize on the XML string so the hot write path skips re-parsing
        # (invalidates itself whenever the config text changes).
        cached = self._rule_cache.get(bucket)
        if cached is not None and cached[0] == raw:
            return cached[1]
        try:
            parsed = parse_replication_xml(raw)
        except ET.ParseError:
            parsed = []
        self._rule_cache[bucket] = (raw, parsed)
        return parsed

    def match(self, bucket: str, object_name: str) -> ReplicationRule | None:
        for r in self.rules(bucket):
            if r.matches(object_name):
                return r
        return None

    def match_all(self, bucket: str, object_name: str) -> list[ReplicationRule]:
        """All matching rules, one per destination ARN (multi-destination
        replication — the reference fans one object out to every configured
        target; site replication relies on this for >2 sites)."""
        out: list[ReplicationRule] = []
        seen: set[str] = set()
        for r in self.rules(bucket):
            if r.matches(object_name) and r.dest_arn not in seen:
                seen.add(r.dest_arn)
                out.append(r)
        return out

    # -- write-path hooks ------------------------------------------------------

    def mark_pending(self, bucket: str, object_name: str, user_defined: dict) -> bool:
        """Called at PUT time (the reference sets PENDING inside putOpts so
        the status is durable before the response, object-handlers.go)."""
        if self.match(bucket, object_name) is None:
            return False
        if user_defined.get(META_REPLICA_STATUS) == REPLICA:
            return False  # replicas are not re-replicated (no loops)
        user_defined[META_REPL_STATUS] = PENDING
        return True

    def on_put(self, bucket: str, oi) -> None:
        if oi.internal.get(META_REPL_STATUS) != PENDING:
            return
        self._enqueue(ReplTask(bucket, oi.name, oi.version_id, "put"))

    def on_delete(self, bucket: str, oi) -> None:
        rules = self.match_all(bucket, oi.name)
        if oi.delete_marker:
            # Marker creation on the source -> marker creation on the target.
            if not any(r.delete_marker_replication for r in rules):
                return
        else:
            # Permanent delete of a specific version: only DeleteReplication
            # authorizes it, and the target delete must be versioned too —
            # an unversioned DELETE would hide the target's live object.
            if not any(r.delete_replication for r in rules):
                return
        self._enqueue(
            ReplTask(bucket, oi.name, oi.version_id, "delete", delete_marker=oi.delete_marker)
        )

    def _enqueue(self, task: ReplTask) -> None:
        try:
            self._q.put_nowait(task)
        except queue.Full:
            with self._retry_lock:
                self._retry.append(task)

    # -- resync (existing-object replication) ---------------------------------

    def resync(self, bucket: str) -> int:
        """Enqueue every existing object matching an ExistingObjectReplication
        rule (the reference's mc replicate resync, bucket-replication.go
        existing-object resync)."""
        n = 0
        marker = ""
        while True:
            listing = self.layer.list_objects(bucket, marker=marker, max_keys=1000)
            for o in listing.objects:
                rules = self.match_all(bucket, o.name)
                if any(r.existing_object_replication for r in rules):
                    self._enqueue(ReplTask(bucket, o.name, o.version_id, "put", existing=True))
                    n += 1
            if not listing.is_truncated:
                return n
            marker = listing.next_marker

    # -- worker ----------------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                task = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if task is None:
                self._q.task_done()
                return
            ok = False
            try:
                ok = self._replicate(task)
            except Exception:
                ok = False
            finally:
                if ok:
                    self.stats.add(completed=1)
                else:
                    self.stats.add(failed=1)
                    task.attempts += 1
                    # Backoff doubles to a 30s ceiling; ~200 attempts rides
                    # out multi-hour peer outages before giving up (the
                    # reference parks failures in a persistent MRF queue;
                    # the scanner's resync pass is the backstop after this).
                    if task.attempts < 200:
                        task.next_at = time.monotonic() + min(
                            30.0, 2.0 ** min(task.attempts, 5)
                        )
                        with self._retry_lock:
                            self._retry.append(task)
                # task_done AFTER retry-list insertion: unfinished_tasks +
                # retry length can never both read zero mid-flight, so
                # pending/drain() cannot report early completion.
                self._q.task_done()

    def _retry_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(1.0)
            now = time.monotonic()
            with self._retry_lock:
                due = [t for t in self._retry if t.next_at <= now]
                self._retry = [t for t in self._retry if t.next_at > now]
            for t in due:
                self._enqueue(t)

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the workers and the retry loop; returns whether they all
        ended. Workers wake within their 0.2s queue poll, the retry loop
        within its 1s sleep; join so teardown never races an in-flight
        replicate. The threads share one `timeout`, and a second call does
        not wait again: a worker inside a replica send to a target that
        stopped answering (TargetClient's 30s timeout) must not hold a
        stopping server past its grace. The threads are daemons, so the
        process exits without them."""
        again = self._stop.is_set()
        self._stop.set()
        deadline = time.monotonic() + (0.0 if again else timeout)
        threads = [*self._threads, self._retry_thread]
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in threads)

    @property
    def pending(self) -> int:
        # unfinished_tasks counts queued AND in-worker tasks (decremented only
        # at task_done), closing the pop-vs-inflight race a qsize()-based
        # count would have.
        with self._q.mutex:
            unfinished = self._q.unfinished_tasks
        with self._retry_lock:
            retry = len(self._retry)
        return unfinished + retry

    def drain(self, timeout: float = 10.0) -> bool:
        """Test/ops helper: wait until queue, workers, and retry list empty."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.pending == 0:
                return True
            time.sleep(0.05)
        return False

    # -- the actual replica write ---------------------------------------------

    def _logical_read(self, bucket: str, name: str, version_id: str):
        """Read object bytes in logical form: SSE-S3 decrypted, decompressed.
        SSE-C objects cannot be read server-side -> not replicable (matches
        the reference, which skips SSE-C)."""
        from . import compress as compress_mod
        from . import crypto as crypto_mod

        oi, data = self.layer.get_object(bucket, name, GetObjectOptions(version_id))
        algo = crypto_mod.is_encrypted(oi.internal)
        if algo == crypto_mod.ALGO_SSE_C:
            return oi, None
        if algo == crypto_mod.ALGO_SSE_S3:
            if self.kms is None:
                return oi, None
            data = crypto_mod.sse_s3_decrypt(data, oi.internal, self.kms, bucket, name)
        if compress_mod.is_compressed(oi.internal):
            data = compress_mod.decompress(data, oi.internal)
        return oi, data

    def _replicate(self, task: ReplTask) -> bool:
        rules = [
            r
            for r in self.match_all(task.bucket, task.object_name)
            # Resync tasks go only to destinations opted into existing objects.
            if not (task.existing and not r.existing_object_replication)
        ]
        if not rules:
            return True  # config removed; nothing to do
        payload = None
        if task.op == "put":
            # One logical read (erasure decode + decrypt + decompress) per
            # task, shared across every destination.
            try:
                payload = self._logical_read(
                    task.bucket, task.object_name, task.version_id
                )
            except (errors.ObjectNotFound, errors.VersionNotFound):
                return True  # gone before we got to it
            oi, data = payload
            if oi.delete_marker:
                return True
            if data is None:  # SSE-C: not replicable, ever — mark and stop
                self._set_status(task, FAILED)
                return True
        ok_all = True
        for rule in rules:
            if not self._replicate_to(task, rule, payload):
                ok_all = False
        if task.op == "put":
            # One status per object version (the reference keeps per-ARN
            # statuses; here FAILED wins so monitoring never reports a
            # replica that a destination is still missing).
            self._set_status(task, COMPLETED if ok_all else FAILED)
        return ok_all

    def _replicate_to(self, task: ReplTask, rule: ReplicationRule, payload) -> bool:
        client = self.targets.client(task.bucket, rule.dest_arn)
        if client is None:
            return False

        if task.op == "delete":
            # Per-target gating: each rule independently authorizes marker /
            # version-delete replication to its destination.
            if task.delete_marker and not rule.delete_marker_replication:
                return True
            if not task.delete_marker and not rule.delete_replication:
                return True
            # Marker creation -> unversioned DELETE on the target (creates its
            # own marker); version delete -> versioned DELETE of the replica
            # version (version ids are preserved across clusters).
            r = client.delete_object(
                task.object_name,
                version_id="" if task.delete_marker else task.version_id,
                headers={HDR_SOURCE_REPL: "true"},
            )
            return r.status_code in (200, 204, 404)

        oi, data = payload
        headers = {
            "content-type": oi.content_type or "application/octet-stream",
            HDR_SOURCE_REPL: "true",
            HDR_SOURCE_VID: oi.version_id,
            HDR_SOURCE_MTIME: repr(oi.mod_time),
        }
        for k, v in oi.user_defined.items():
            if k.startswith("x-amz-meta-") or k in (
                "cache-control",
                "content-disposition",
                "content-encoding",
                "content-language",
                # object-lock retention / legal hold travel with the replica
                # (requires a lock-enabled target bucket, as in the reference)
                "x-amz-object-lock-mode",
                "x-amz-object-lock-retain-until-date",
                "x-amz-object-lock-legal-hold",
            ):
                headers[k] = v
        # Object tags (stored internally, replicated as x-amz-tagging).
        raw_tags = oi.internal.get("x-internal-tags", "")
        if raw_tags:
            headers["x-amz-tagging"] = raw_tags
        # Throttle replica traffic against the target's bandwidth limit and
        # feed the live monitor (internal/bucket/bandwidth role). The limit
        # is re-read per task (cached bucket meta, no KMS unseal) so an
        # admin update applies to in-flight queues.
        self.bandwidth.set_limit(
            task.bucket, rule.dest_arn, self.targets.bandwidth_of(task.bucket, rule.dest_arn)
        )
        self.bandwidth.throttle(task.bucket, rule.dest_arn, len(data))
        r = client.put_object(task.object_name, data, headers)
        ok = r.status_code == 200
        if ok:
            self.stats.add(replicated_bytes=len(data))
            self.bandwidth.record(task.bucket, rule.dest_arn, len(data))
        return ok

    def _set_status(self, task: ReplTask, status: str) -> None:
        try:
            self.layer.put_object_metadata(
                task.bucket,
                task.object_name,
                task.version_id,
                updates={META_REPL_STATUS: status},
            )
        except errors.StorageError:
            pass
