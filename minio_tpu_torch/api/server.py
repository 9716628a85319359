"""S3-compatible HTTP API server (aiohttp).

Role of the reference's API front (cmd/api-router.go, object-handlers.go,
bucket-handlers.go): routes S3 REST onto the object layer. Request flow per
handler mirrors the reference's order: auth (SigV4 header / presigned /
anonymous+policy) -> policy authorization -> handler -> object layer, with
S3-coded XML errors throughout.

The object layer is synchronous (thread-pooled drive IO); handlers hop to a
worker thread via asyncio.to_thread so the event loop only does protocol work
-- the asyncio analogue of the reference's goroutine-per-request model.

This is the JAX package's api/server.py over the port's ServerPools: the
same routing, handlers, admission gate, CORS, RFC 7232 conditionals,
streaming PUT and streaming GET plan, with the same bytes on the wire and
on the drives, and the same instrumentation hooks: the request root span
and its child spans, the ops/s ring, the degrade records, the copy-ledger
hops, GLOBAL_LOGGER and the bucket events of `notifier` (control/events.py,
with ListenNotification over api/streams.py), the replication and site
replication hooks, STS (api/sts.py) and SelectObjectContent (s3select/),
which reads the object through the layer's GET like any other reader.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import datetime
import hashlib
import json
import re
import secrets
import threading
import time as _time
import urllib.parse
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

from aiohttp import web

from ..control.bucket_meta import BucketMetadataSys
from ..control.compress import META_ACTUAL_SIZE
from ..control.degrade import GLOBAL_DEGRADE
from ..control.logging import GLOBAL_LOGGER
from ..control.perf import GLOBAL_PERF, op_class
from ..control import objectlock as ol
from ..control import tiering as tiering_mod
from ..control.iam import IAMSys
from ..control import policy as policy_mod
from ..control import tracing
from ..control.profiler import COPIED, GLOBAL_PROFILER, MOVED
from ..object.pools import ServerPools
from ..object.types import (
    DeleteObjectOptions,
    GetObjectOptions,
    ObjectInfo,
    PutObjectOptions,
)
from ..utils import deadline
from ..utils import errors as oerr
from . import zipext
from .auth import SigV4Verifier, UNSIGNED_PAYLOAD
from .errors import S3Error, from_object_error
from ..control.sanitizer import san_lock


MAX_OBJECT_SIZE = 5 * (1 << 30)  # single-PUT cap, matching S3

XML_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _iso(ts: float) -> str:
    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]
        + "Z"
    )


def _http_date(ts: float) -> str:
    return datetime.datetime.fromtimestamp(ts, datetime.timezone.utc).strftime(
        "%a, %d %b %Y %H:%M:%S GMT"
    )


def _xml(content: str, status: int = 200) -> web.Response:
    return web.Response(
        status=status,
        body=('<?xml version="1.0" encoding="UTF-8"?>\n' + content).encode(),
        content_type="application/xml",
    )


def delete_bucket_with_hooks(
    layer, bucket: str, *, bucket_meta=None, notification=None, site_repl=None,
    notifier=None,
) -> None:
    """Bucket delete plus every cache/replication hook, in one place for
    the S3 handler AND the console (a hook added to only one path would
    leave the other resurrecting stale state):
      * bucket_meta.delete — or a later bucket of the same name inherits
        the old quota/lock/versioning config;
      * peer reload — peers' bucket-meta AND bucket-existence caches must
        drop NOW, not after their TTL window, or they keep accepting PUTs
        into the deleted namespace;
      * LOCAL notifier rules — the peer broadcast excludes this node, and
        stale rules would fire the old event config if the bucket is ever
        recreated here;
      * site replication fan-out."""
    layer.delete_bucket(bucket)
    if bucket_meta is not None:
        bucket_meta.delete(bucket)  # its on_change hook broadcasts to peers
    elif notification is not None:
        notification.reload_bucket_meta_all(bucket)
    if notifier is not None:
        notifier.set_bucket_rules_from_xml(bucket, b"")
    if site_repl is not None and getattr(site_repl, "enabled", False):
        site_repl.on_bucket_delete(bucket)


def _read_all(reader, chunk: int = 1 << 20) -> bytes:
    out = bytearray()
    while True:
        b = reader.read(chunk)
        if not b:
            return bytes(out)
        out += b


class _RequestBodyReader:
    """Sync .read(n) / .readinto(buf) over an aiohttp request body.

    The object layer streams from a worker thread; each refill hops to the
    event loop for the next body chunk (readahead pipelining: the socket
    fills while the previous block encodes). ``readany()`` hands back
    aiohttp's buffered chunk as-is -- ``content.read(n)`` would re-slice
    and re-join it -- and ``readinto`` lands it straight into the caller's
    pooled buffer: one landing, no intermediate bytes staging (the
    recv_into fix for the socket-read double copy)."""

    def __init__(self, request: web.Request, loop: asyncio.AbstractEventLoop):
        self._content = request.content
        self._loop = loop
        self._chunk: bytes = b""
        self._pos = 0

    def _refill(self) -> bool:
        fut = asyncio.run_coroutine_threadsafe(self._content.readany(), self._loop)
        self._chunk = fut.result(timeout=600)
        self._pos = 0
        return bool(self._chunk)

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        if self._pos >= len(self._chunk) and not self._refill():
            return b""
        take = min(n, len(self._chunk) - self._pos)
        data = self._chunk[self._pos : self._pos + take]
        self._pos += take
        # Copy-ledger hop: slicing materializes a fresh bytes object.
        GLOBAL_PROFILER.copy.record("socket-read", COPIED, len(data))
        return data

    def readinto(self, dest) -> int:
        """Land the next body bytes directly into `dest`; 0 at EOF."""
        if len(dest) == 0:
            return 0
        if self._pos >= len(self._chunk) and not self._refill():
            return 0
        take = min(len(dest), len(self._chunk) - self._pos)
        dest[:take] = self._chunk[self._pos : self._pos + take]
        self._pos += take
        # Copy-ledger hop: the socket chunk lands once in the caller's
        # (pooled) buffer and is passed along as views from here on.
        GLOBAL_PROFILER.copy.record("socket-read", MOVED, take)
        return take


class _HashVerifyReader:
    """Pass-through reader enforcing size limit + payload digests at EOF.

    The reference's hash.Reader (internal/hash/reader.go): the declared
    x-amz-content-sha256 / Content-Md5 are verified against the streamed
    bytes; a mismatch fails the request after staging, never committing."""

    def __init__(self, reader, want_sha256_hex=None, want_md5_b64=None, limit=MAX_OBJECT_SIZE):
        self._r = reader
        self._sha = hashlib.sha256() if want_sha256_hex else None
        self._want_sha = want_sha256_hex
        self._md5 = hashlib.md5() if want_md5_b64 else None
        self._want_md5 = want_md5_b64
        self._limit = limit
        self._n = 0
        self._checked = False

    def _consumed(self, nbytes: int, view=None) -> None:
        self._n += nbytes
        if self._n > self._limit:
            raise S3Error("EntityTooLarge")
        if self._sha is not None:
            self._sha.update(view)
        if self._md5 is not None:
            self._md5.update(view)

    def _at_eof(self) -> None:
        if self._checked:
            return
        self._checked = True
        if self._sha is not None and self._sha.hexdigest() != self._want_sha:
            raise S3Error("XAmzContentSHA256Mismatch")
        if self._md5 is not None:
            want = base64.b64decode(self._want_md5)
            if self._md5.digest() != want:
                raise S3Error("BadDigest")

    def read(self, n: int) -> bytes:
        chunk = self._r.read(n)
        if chunk:
            self._consumed(len(chunk), chunk)
        else:
            self._at_eof()
        return chunk

    def readinto(self, dest) -> int:
        """Zero-copy pass-through: delegate landing to the inner reader and
        hash the landed view in place."""
        ri = getattr(self._r, "readinto", None)
        if ri is not None:
            got = ri(dest)
        else:
            b = self._r.read(len(dest))
            got = len(b)
            dest[:got] = b
        if got:
            self._consumed(got, dest[:got])
        else:
            self._at_eof()
        return got

    def md5_hexdigest(self) -> str | None:
        """Hex MD5 of the verified body (valid after EOF): lets the PUT
        path keep a true-MD5 ETag when the client declared Content-Md5."""
        if self._md5 is None or not self._checked:
            return None
        return self._md5.hexdigest()


class _StreamPlan:
    """A prepared streaming GET: headers + a blocking chunk iterator."""

    def __init__(self, status: int, headers: dict, iterator, content_length: int):
        self.status = status
        self.headers = headers
        self.iterator = iterator
        self.content_length = content_length


def _rfc7232_outcome(
    headers, etag: str, mod_time: float, prefix: str = ""
) -> str | None:
    """Evaluate RFC 7232 preconditions: returns "match_failed" (-> 412),
    "not_modified" (-> 304 on GET/HEAD, 412 on copy), or None.

    Section 6 order: If-Match first (supersedes If-Unmodified-Since), then
    If-None-Match (supersedes If-Modified-Since). HTTP dates compare at
    second granularity. `prefix` selects the x-amz-copy-source-if-* family.
    """
    from email.utils import parsedate_to_datetime

    def httpdate(name: str) -> float | None:
        v = headers.get(name)
        if not v:
            return None
        try:
            return parsedate_to_datetime(v).timestamp()
        except (TypeError, ValueError):
            return None

    def hdr(name: str) -> str | None:
        return headers.get(prefix + name if prefix else name)

    mod_s = int(mod_time)
    im = hdr("If-Match" if not prefix else "match")
    if im is not None:
        if im.strip('"') != etag and im.strip() != "*":
            return "match_failed"
    else:
        ius_name = (prefix + "unmodified-since") if prefix else "If-Unmodified-Since"
        ius = httpdate(ius_name)
        if ius is not None and mod_s > int(ius):
            return "match_failed"
    inm = hdr("If-None-Match" if not prefix else "none-match")
    if inm is not None:
        if inm.strip('"') == etag or inm.strip() == "*":
            return "not_modified"
    else:
        ims_name = (prefix + "modified-since") if prefix else "If-Modified-Since"
        ims = httpdate(ims_name)
        if ims is not None and mod_s <= int(ims):
            return "not_modified"
    return None


def _enc_key(name: str, url_encode: bool) -> str:
    """Key/prefix encoding for list responses: S3's encoding-type=url
    percent-encodes everything but unreserved chars and '/' (boto3 and mc
    request it by default so control characters survive XML)."""
    if url_encode:
        return urllib.parse.quote(name, safe="/")
    return escape(name)


def _display_size(o: ObjectInfo) -> int:
    """Logical object size for listings/HEAD: transformed objects store
    compressed/encrypted bytes, but S3 clients (sync tools especially)
    compare listing sizes against local files — they must see the actual
    size, as the reference's ObjectInfo.GetActualSize does."""
    raw = o.internal.get(META_ACTUAL_SIZE, "")
    return int(raw) if raw else o.size


def _obj_xml(o: ObjectInfo, url_encode: bool = False) -> str:
    return (
        f"<Contents><Key>{_enc_key(o.name, url_encode)}</Key>"
        f"<LastModified>{_iso(o.mod_time)}</LastModified>"
        f"<ETag>&quot;{o.etag}&quot;</ETag><Size>{_display_size(o)}</Size>"
        f"<StorageClass>{o.storage_class}</StorageClass>"
        "<Owner><ID>minio-tpu</ID><DisplayName>minio-tpu</DisplayName></Owner>"
        "</Contents>"
    )


class S3Server:
    def __init__(
        self,
        layer: ServerPools,
        iam: IAMSys,
        region: str = "us-east-1",
        check_skew: bool = True,
        kms=None,
        config=None,
    ):
        self.layer = layer
        self.iam = iam
        self.region = region
        self.kms = kms
        self.config = config
        self.bucket_meta = BucketMetadataSys(layer)
        self.verifier = SigV4Verifier(iam.lookup, region, check_skew)
        import os as _os

        self._cors_allow = _os.environ.get("MINIO_API_CORS_ALLOW_ORIGIN", "*")
        self._cors_set = (
            None
            if self._cors_allow == "*"
            else {a.strip() for a in self._cors_allow.split(",")}
        )
        # Node-level admission control (the reference's MINIO_API_REQUESTS_MAX
        # throttle, cmd/generic-handlers.go maxClients): requests past the cap
        # are shed IMMEDIATELY with a retryable 503 instead of queueing until
        # every one of them times out. 0 disables the gate.
        self._max_requests = int(_os.environ.get("MTPU_API_REQUESTS_MAX", "512"))
        self._inflight = 0
        self._inflight_lock = san_lock("S3Server._inflight_lock")
        self.app = web.Application(client_max_size=MAX_OBJECT_SIZE)
        self.app.router.add_route("*", "/{tail:.*}", self._entry)
        # Hooks filled in by the control plane (events, metrics, trace).
        self.on_event = None
        self.notifier = None
        self.metrics = None
        self.trace = None
        self.logger = None
        self.replication = None  # ReplicationSys (bucket-replication.go role)
        self.peer_notification = None  # NotificationSys: peer listen/trace merge
        self.quota_usage = None  # callable(bucket) -> used bytes | None (quota checks)
        self.site_repl = None  # SiteReplicationSys (site-replication.go role)
        self.tiering = None  # TierConfigMgr (tier.go / bucket-lifecycle.go role)

    # -- plumbing -------------------------------------------------------------

    def _conditional_response(
        self, request: web.Request, oi, bucket: str, key: str
    ) -> web.Response | None:
        """RFC 7232 conditionals for GET/HEAD: the 304 response when a
        cache precondition holds, a 412 raise on failed match, else None."""
        outcome = _rfc7232_outcome(request.headers, oi.etag, oi.mod_time)
        if outcome == "match_failed":
            raise S3Error("PreconditionFailed", resource=f"/{bucket}/{key}")
        if outcome == "not_modified":
            # RFC 7232 §4.1: a 304 carries the headers a 200 would (metadata
            # refresh for caches) minus any body-specific ones.
            return web.Response(status=304, headers=self._object_headers(oi))
        return None

    # CORS (the reference's generic-handlers.go CorsHandler): permissive by
    # default, restrictable via MINIO_API_CORS_ALLOW_ORIGIN (comma list).
    def _cors_origin(self, request: web.Request) -> str | None:
        origin = request.headers.get("Origin", "")
        if not origin:
            return None
        if self._cors_set is None:
            return "*"
        return origin if origin in self._cors_set else None

    def _cors_headers(self, request: web.Request) -> dict[str, str]:
        origin = self._cors_origin(request)
        if origin is None:
            return {}
        return {
            "Access-Control-Allow-Origin": origin,
            "Access-Control-Expose-Headers": "ETag, x-amz-request-id, x-amz-version-id",
            "Vary": "Origin",
        }

    async def _entry(self, request: web.Request) -> web.Response:
        request_id = secrets.token_hex(8).upper()
        t0 = _time.perf_counter()
        bucket, key = self._split_path(request)
        api_name = _api_name(request.method, bucket, key, request.rel_url.query)
        is_write = request.method in ("PUT", "POST", "DELETE")
        # The request root span: trace id == x-amz-request-id, so trace and
        # audit records join on one key. No-op when nobody subscribes.
        root = tracing.root_span(
            api_name,
            "api",
            request_id,
            sys=self.trace,
            method=request.method,
            path=request.path,
        )
        # Admission gate BEFORE any work: an overloaded node answers in
        # microseconds so clients back off onto healthier nodes.
        admitted = True
        if self._max_requests > 0:
            with self._inflight_lock:
                if self._inflight >= self._max_requests:
                    admitted = False
                else:
                    self._inflight += 1
        if not admitted:
            GLOBAL_DEGRADE.record_shed("write" if is_write else "read")
            shed = S3Error(
                "SlowDownWrite" if is_write else "SlowDownRead",
                resource=f"/{bucket}/{key}" if bucket else "/",
            )
            resp = _xml(shed.to_xml(request_id), shed.api.http_status)
            resp.headers["x-amz-request-id"] = request_id
            resp.headers["Retry-After"] = "1"
            with root:
                root.set(status=resp.status, shed=True)
            if self.metrics is not None:
                self.metrics.record_http(request.method, resp.status)
            # Shed requests land in the ops/s ring as errors: a dashboard
            # reading QPS during an overload must see the refusals.
            GLOBAL_PERF.timeseries.record(
                op_class(api_name), _time.perf_counter() - t0, ok=False
            )
            return resp
        # The client's remaining budget (X-Mtpu-Deadline, seconds) binds the
        # whole dispatch: every internal RPC below inherits and decrements it.
        dl = deadline.bind_header(request.headers.get(deadline.DEADLINE_HEADER))
        try:
            with root, dl:
                try:
                    resp = await self._dispatch(request, request_id)
                except S3Error as e:
                    resp = _xml(e.to_xml(request_id), e.api.http_status)
                except (oerr.StorageError, ValueError) as e:
                    if isinstance(e, oerr.DeadlineExceeded):
                        # By method: reads shed as SlowDownRead, writes as
                        # SlowDownWrite (both 503, both retryable).
                        s3e = S3Error(
                            "SlowDownWrite" if is_write else "SlowDownRead",
                            resource=f"/{bucket}/{key}",
                        )
                    elif isinstance(e, oerr.StorageError):
                        s3e = from_object_error(e, bucket, key)
                    else:
                        s3e = S3Error("InvalidArgument", str(e))
                    resp = _xml(s3e.to_xml(request_id), s3e.api.http_status)
                root.set(status=resp.status)
        finally:
            if self._max_requests > 0:
                with self._inflight_lock:
                    self._inflight -= 1
        duration = _time.perf_counter() - t0
        if not resp.prepared:  # streamed responses already sent their headers
            resp.headers["x-amz-request-id"] = request_id
            for hk, hv in self._cors_headers(request).items():
                resp.headers.setdefault(hk, hv)
            resp.headers.setdefault("Server", "MinIO-TPU")
            if resp.status == 503:
                # Every throttle answer carries the back-off hint.
                resp.headers.setdefault("Retry-After", "1")
        if self.metrics is not None:
            self.metrics.record_http(request.method, resp.status)
            self.metrics.record_api(api_name, duration, resp.status < 400)
        # Always-on ops/s ring (control/perf.py OpsTimeSeries): one bump per
        # request under its op class. Bytes from the headers -- rx is the
        # client's declared body, tx what we are about to send.
        try:
            nbytes = int(request.headers.get("Content-Length") or 0) + (
                resp.content_length or 0
            )
        except (TypeError, ValueError):
            nbytes = 0
        GLOBAL_PERF.timeseries.record(
            op_class(api_name), duration, ok=resp.status < 400, nbytes=nbytes
        )
        if self.trace is not None and self.trace.enabled():
            self.trace.publish(
                "http",
                method=request.method,
                path=request.path,
                status=resp.status,
                duration_ms=round(duration * 1000, 3),
                request_id=request_id,
            )
        if self.logger is not None:
            self.logger.audit(
                api=api_name,
                bucket=bucket,
                object_name=key,
                status_code=resp.status,
                duration_ms=round(duration * 1000, 3),
                remote=request.remote or "",
                request_id=request_id,
            )
        return resp

    def _split_path(self, request: web.Request) -> tuple[str, str]:
        path = urllib.parse.unquote(request.path)
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return bucket, key

    def _authenticate(self, request: web.Request, body: bytes) -> tuple[str, bytes]:
        """Returns (authenticated access key, effective payload bytes).

        Auth types (getRequestAuthType, cmd/auth-handler.go equivalent):
        V4 signed / presigned, V4 streaming-signed (aws-chunked), V2 signed /
        presigned, anonymous. Streaming requests return the decoded payload.
        """
        from . import sigv2 as sigv2_mod
        from . import streaming as streaming_mod

        headers = dict(request.headers)
        query = [(k, v) for k, v in request.rel_url.query.items()]
        path = urllib.parse.unquote(request.path)
        if "X-Amz-Signature" in request.rel_url.query:
            return self.verifier.verify_presigned(request.method, path, query, headers), body
        if sigv2_mod.is_v2_presigned(request.rel_url.query):
            v2 = sigv2_mod.SigV2Verifier(self.iam.lookup)
            return v2.verify_presigned(request.method, path, query), body
        if sigv2_mod.is_v2_signed(headers):
            v2 = sigv2_mod.SigV2Verifier(self.iam.lookup)
            return v2.verify_signed(request.method, path, query, headers), body
        if "Authorization" in request.headers:
            access_key = self.verifier.verify_signed(
                request.method, path, query, headers, body
            )
            if streaming_mod.is_streaming_request(headers):
                from .auth import parse_authorization

                h = {k.lower(): v for k, v in headers.items()}
                auth = parse_authorization(h.get("authorization", ""))
                creds = self.iam.lookup(auth.access_key)
                body = streaming_mod.decode_chunked(
                    body,
                    seed_signature=auth.signature,
                    secret_key=creds.secret_key,
                    amz_date=h.get("x-amz-date", ""),
                    region=auth.region,
                )
            return access_key, body
        return "", body  # anonymous

    def _authenticate_streaming(self, request: web.Request, base_reader):
        """Header-only authentication for streaming uploads: returns
        (access_key, verified_reader). Payload digests (declared sha256,
        Content-Md5, aws-chunked per-chunk signatures) are verified by the
        reader chain as the object layer consumes the body."""
        from . import sigv2 as sigv2_mod
        from . import streaming as streaming_mod
        from .auth import parse_authorization

        headers = dict(request.headers)
        h = {k.lower(): v for k, v in headers.items()}
        query = [(k, v) for k, v in request.rel_url.query.items()]
        path = urllib.parse.unquote(request.path)
        want_md5 = h.get("content-md5")

        if "X-Amz-Signature" in request.rel_url.query:
            ak = self.verifier.verify_presigned(request.method, path, query, headers)
            return ak, _HashVerifyReader(base_reader, want_md5_b64=want_md5)
        if sigv2_mod.is_v2_presigned(request.rel_url.query):
            v2 = sigv2_mod.SigV2Verifier(self.iam.lookup)
            ak = v2.verify_presigned(request.method, path, query)
            return ak, _HashVerifyReader(base_reader, want_md5_b64=want_md5)
        if sigv2_mod.is_v2_signed(headers):
            v2 = sigv2_mod.SigV2Verifier(self.iam.lookup)
            ak = v2.verify_signed(request.method, path, query, headers)
            return ak, _HashVerifyReader(base_reader, want_md5_b64=want_md5)
        if "Authorization" in request.headers:
            ak = self.verifier.verify_signed(request.method, path, query, headers, None)
            if streaming_mod.is_streaming_request(headers):
                auth = parse_authorization(h.get("authorization", ""))
                creds = self.iam.lookup(auth.access_key)
                rdr = streaming_mod.SignedChunkReader(
                    base_reader,
                    seed_signature=auth.signature,
                    secret_key=creds.secret_key,
                    amz_date=h.get("x-amz-date", ""),
                    region=auth.region,
                )
                return ak, _HashVerifyReader(rdr, want_md5_b64=want_md5)
            payload_hash = h.get("x-amz-content-sha256", UNSIGNED_PAYLOAD)
            want_sha = payload_hash if payload_hash != UNSIGNED_PAYLOAD else None
            return ak, _HashVerifyReader(
                base_reader, want_sha256_hex=want_sha, want_md5_b64=want_md5
            )
        return "", _HashVerifyReader(base_reader, want_md5_b64=want_md5)  # anonymous

    async def _streaming_put_entry(
        self, request: web.Request, bucket: str, key: str
    ) -> web.Response:
        clen = request.content_length
        if clen is not None and clen > MAX_OBJECT_SIZE + (1 << 20):
            raise S3Error("EntityTooLarge")
        base = _RequestBodyReader(request, asyncio.get_running_loop())
        with tracing.span("auth", "api"):
            access_key, reader = await asyncio.to_thread(
                self._authenticate_streaming, request, base
            )
        request["access_key"] = access_key
        q = request.rel_url.query
        action = policy_mod.s3_action("PUT", bucket, key, q)
        await asyncio.to_thread(self._authorize, access_key, action, bucket, key, request)
        # Quota for streaming bodies. aws-chunked requests declare the
        # payload size in x-amz-decoded-content-length (a SIGNED header --
        # Content-Length includes chunk framing); the header is honored only
        # for actually-streaming-signed requests so a plain PUT cannot
        # smuggle a small declared size past the check. Chunked transfers
        # without a usable size check with 0, like the reference's
        # unknown-size path.
        from . import streaming as streaming_mod

        decoded = request.headers.get("x-amz-decoded-content-length", "")
        if streaming_mod.is_streaming_request(dict(request.headers)) and decoded.isdigit():
            size = int(decoded)
        else:
            size = request.content_length or 0
        await asyncio.to_thread(self._check_quota, bucket, size)
        if "uploadId" in q and "partNumber" in q:
            return await asyncio.to_thread(
                self._upload_part, bucket, key, q["uploadId"], int(q["partNumber"]), reader
            )
        return await asyncio.to_thread(self._put_object, bucket, key, reader, request)

    @staticmethod
    def _policy_context(request: web.Request | None) -> dict:
        """Condition keys for policy evaluation (the reference's
        policy.Args: aws:SourceIp, aws:Referer, s3:prefix, ...)."""
        if request is None:
            return {}
        q = request.rel_url.query
        return {
            "aws:SourceIp": request.remote or "",
            "aws:Referer": request.headers.get("Referer", ""),
            "aws:SecureTransport": "true" if request.secure else "false",
            "s3:prefix": q.get("prefix", ""),
            "s3:delimiter": q.get("delimiter", ""),
            "s3:max-keys": q.get("max-keys", ""),
        }

    def _authorize(
        self,
        access_key: str,
        action: str,
        bucket: str,
        key: str,
        request: web.Request | None = None,
    ) -> None:
        context = self._policy_context(request)
        resource = policy_mod.resource_arn(bucket, key)
        if access_key:
            if self.iam.is_allowed(access_key, action, resource, context):
                return
            raise S3Error("AccessDenied", resource=f"/{bucket}/{key}")
        # Anonymous: only bucket policy can grant.
        if bucket:
            meta = self.bucket_meta.get(bucket)
            if meta.policy_json:
                pol = policy_mod.Policy.from_json(meta.policy_json)
                if pol.is_allowed(action, resource, context):
                    return
        raise S3Error("AccessDenied", resource=f"/{bucket}/{key}")

    @staticmethod
    async def _read_buffered_body(request: web.Request) -> bytes | bytearray:
        """Buffered body for non-streaming handlers, landed once.

        When Content-Length is declared, socket chunks land straight into
        one exact-size buffer (the readinto analogue of request.read(),
        which stages every chunk and then joins them -- the duplicate copy
        this replaces). Unknown lengths keep the join fallback."""
        clen = request.content_length
        if clen is None or clen > MAX_OBJECT_SIZE + (1 << 20):
            body = await request.read()
            # Copy-ledger hop: chunk staging + join materializes the body.
            GLOBAL_PROFILER.copy.record("socket-read", COPIED, len(body))
            return body
        if clen == 0:
            return b""
        buf = bytearray(clen)
        view = memoryview(buf)
        pos = 0
        content = request.content
        while pos < clen:
            chunk = await content.readany()
            if not chunk:
                break
            take = min(len(chunk), clen - pos)
            view[pos : pos + take] = chunk[:take]
            pos += take
        if pos < clen:
            del buf[pos:]
        # Copy-ledger hop: one landing into the right-sized buffer; handlers
        # consume the bytearray in place.
        GLOBAL_PROFILER.copy.record("socket-read", MOVED, pos)
        return buf

    async def _dispatch(self, request: web.Request, request_id: str) -> web.Response:
        if (
            request.method == "OPTIONS"
            and "Origin" in request.headers
            and "Access-Control-Request-Method" in request.headers
        ):
            # A genuine CORS preflight (generic-handlers CorsHandler role):
            # anonymous by design, instrumented like every other request.
            # Non-CORS OPTIONS falls through to routing (MethodNotAllowed).
            origin = self._cors_origin(request)
            if origin is None:
                return web.Response(status=403)
            return web.Response(
                status=200,
                headers={
                    "Access-Control-Allow-Origin": origin,
                    "Access-Control-Allow-Methods": "GET, PUT, POST, DELETE, HEAD",
                    "Access-Control-Allow-Headers": request.headers.get(
                        "Access-Control-Request-Headers", "*"
                    ),
                    "Access-Control-Max-Age": "3600",
                    "Vary": "Origin",
                },
            )
        if request.path == "/minio/v2/metrics/node":
            if self.metrics is None:
                raise S3Error("NotImplemented")
            return web.Response(
                text=self.metrics.render_node(), content_type="text/plain"
            )
        if request.path == "/minio/v2/metrics/cluster":
            if self.metrics is None:
                raise S3Error("NotImplemented")
            # Cluster view fans out HTTP calls to peers -> off the event loop.
            text = await asyncio.to_thread(self.metrics.render_cluster)
            return web.Response(text=text, content_type="text/plain")
        bucket, key = self._split_path(request)
        # Object PUTs (plain and upload-part) stream: auth from headers, the
        # body flows through verified readers into the erasure pipeline
        # without ever materializing (the reference's PutObjectHandler
        # hash.Reader -> erasure.Encode chain, object-handlers.go:1638-1712).
        if (
            request.method == "PUT"
            and key
            and "x-amz-copy-source" not in request.headers
            and not ({"tagging", "retention", "legal-hold", "acl"} & set(request.rel_url.query))
        ):
            return await self._streaming_put_entry(request, bucket, key)
        with tracing.span("body-read", "api"):
            body = await self._read_buffered_body(request)
        # POST policy form uploads authenticate via the policy signature in
        # the form, not request headers (PostPolicyBucketHandler equivalent).
        ctype = request.headers.get("Content-Type", "")
        if (
            bucket
            and not key
            and request.method == "POST"
            and ctype.startswith("multipart/form-data")
        ):
            return await asyncio.to_thread(
                self._post_policy_upload, bucket, body, ctype, request
            )
        with tracing.span("auth", "api"):
            access_key, body = await asyncio.to_thread(self._authenticate, request, body)
        request["access_key"] = access_key
        q = request.rel_url.query

        # STS rides the root path and needs authentication only -- any
        # signed principal may request temporary credentials
        # (sts-handlers.go AssumeRole: auth, not policy).
        if not bucket and request.method == "POST":
            from . import sts as sts_mod

            form = sts_mod.parse_form(body)
            if "Action" in form:
                return await asyncio.to_thread(
                    sts_mod.handle_sts, self.iam, access_key, form, self.config, request
                )

        action = policy_mod.s3_action(request.method, bucket, key, q)
        await asyncio.to_thread(self._authorize, access_key, action, bucket, key, request)

        if not bucket:
            if request.method == "GET":
                if "events" in q:
                    # Cluster-wide live event stream (ListenNotificationHandler,
                    # cmd/listen-notification-handlers.go:31, root-path route).
                    return await self._listen_notification(request, "")
                return await asyncio.to_thread(self._list_buckets)
            raise S3Error("MethodNotAllowed")
        if not key:
            return await self._bucket_op(request, bucket, body)
        return await self._object_op(request, bucket, key, body)

    # -- service --------------------------------------------------------------

    def _list_buckets(self) -> web.Response:
        buckets = self.layer.list_buckets()
        items = "".join(
            f"<Bucket><Name>{escape(b.name)}</Name>"
            f"<CreationDate>{_iso(b.created)}</CreationDate></Bucket>"
            for b in buckets
        )
        return _xml(
            f'<ListAllMyBucketsResult xmlns="{XML_NS}">'
            "<Owner><ID>minio-tpu</ID><DisplayName>minio-tpu</DisplayName></Owner>"
            f"<Buckets>{items}</Buckets></ListAllMyBucketsResult>"
        )

    # -- bucket ---------------------------------------------------------------

    async def _bucket_op(self, request: web.Request, bucket: str, body: bytes) -> web.Response:
        q = request.rel_url.query
        m = request.method
        if m == "HEAD":
            exists = await asyncio.to_thread(self.layer.bucket_exists, bucket)
            if not exists:
                return web.Response(status=404)
            return web.Response(status=200)
        if m == "PUT":
            if "versioning" in q:
                return await asyncio.to_thread(self._put_versioning, bucket, body)
            if "policy" in q:
                return await asyncio.to_thread(self._put_policy, bucket, body)
            if "tagging" in q:
                return await asyncio.to_thread(self._put_bucket_tagging, bucket, body)
            if "lifecycle" in q:
                return await asyncio.to_thread(
                    self._put_bucket_config, bucket, "lifecycle_xml", body
                )
            if "encryption" in q:
                return await asyncio.to_thread(
                    self._put_bucket_config, bucket, "encryption_xml", body
                )
            if "replication-reset" in q:
                # ResetBucketReplicationState (MinIO extension,
                # api-router.go:420): requeue existing objects for
                # replication to the configured targets.
                return await asyncio.to_thread(self._replication_reset, bucket)
            if "replication" in q:
                return await asyncio.to_thread(
                    self._put_bucket_config, bucket, "replication_xml", body
                )
            if "notification" in q:
                return await asyncio.to_thread(
                    self._put_bucket_config, bucket, "notification_xml", body
                )
            if "object-lock" in q:
                return await asyncio.to_thread(self._put_object_lock_config, bucket, body)
            if "cors" in q:
                return await asyncio.to_thread(self._put_bucket_config, bucket, "cors_xml", body)
            if "acl" in q:
                return await asyncio.to_thread(self._put_acl, bucket, request, body)
            return await asyncio.to_thread(self._make_bucket, bucket, request)
        if m == "GET":
            if "location" in q:
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                loc = "" if self.region == "us-east-1" else self.region
                return _xml(f'<LocationConstraint xmlns="{XML_NS}">{loc}</LocationConstraint>')
            if "versioning" in q:
                return await asyncio.to_thread(self._get_versioning, bucket)
            if "policy" in q:
                return await asyncio.to_thread(self._get_policy, bucket)
            if "tagging" in q:
                return await asyncio.to_thread(self._get_bucket_tagging, bucket)
            if "lifecycle" in q:
                return await asyncio.to_thread(
                    self._get_bucket_config, bucket, "lifecycle_xml", "NoSuchLifecycleConfiguration"
                )
            if "encryption" in q:
                return await asyncio.to_thread(
                    self._get_bucket_config,
                    bucket,
                    "encryption_xml",
                    "ServerSideEncryptionConfigurationNotFoundError",
                )
            if "replication" in q:
                return await asyncio.to_thread(
                    self._get_bucket_config,
                    bucket,
                    "replication_xml",
                    "ReplicationConfigurationNotFoundError",
                )
            if "notification" in q:
                return await asyncio.to_thread(self._get_notification, bucket)
            if "object-lock" in q:
                return await asyncio.to_thread(
                    self._get_bucket_config, bucket, "object_lock_xml", "ObjectLockConfigurationNotFoundError"
                )
            if "cors" in q:
                return await asyncio.to_thread(
                    self._get_bucket_config, bucket, "cors_xml", "NoSuchCORSConfiguration"
                )
            if "events" in q:
                # Live per-bucket event stream (mc watch;
                # cmd/listen-notification-handlers.go:31).
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                return await self._listen_notification(request, bucket)
            if "policyStatus" in q:
                return await asyncio.to_thread(self._get_policy_status, bucket)
            if "acl" in q:
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                return _xml(self._acl_xml())
            # AWS-compat fixed-config subresources (the reference serves
            # constant defaults for these, cmd/dummy-handlers.go).
            if "accelerate" in q:
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                return _xml(f'<AccelerateConfiguration xmlns="{XML_NS}"/>')
            if "requestPayment" in q:
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                return _xml(
                    f'<RequestPaymentConfiguration xmlns="{XML_NS}">'
                    "<Payer>BucketOwner</Payer></RequestPaymentConfiguration>"
                )
            if "logging" in q:
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                return _xml(f'<BucketLoggingStatus xmlns="{XML_NS}"/>')
            if "website" in q:
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                raise S3Error("NoSuchWebsiteConfiguration", resource=f"/{bucket}")
            if "replication-metrics" in q:
                return await asyncio.to_thread(self._replication_metrics, bucket)
            if "uploads" in q:
                return await asyncio.to_thread(self._list_multipart_uploads, bucket, q)
            if "versions" in q:
                return await asyncio.to_thread(self._list_versions, bucket, q)
            return await asyncio.to_thread(self._list_objects, bucket, q, request)
        if m == "DELETE":
            if "policy" in q:
                return await asyncio.to_thread(self._delete_policy, bucket)
            if "tagging" in q:
                return await asyncio.to_thread(self._put_bucket_tagging, bucket, b"")
            if "lifecycle" in q:
                return await asyncio.to_thread(self._put_bucket_config, bucket, "lifecycle_xml", b"")
            if "encryption" in q:
                # DeleteBucketEncryptionHandler role.
                return await asyncio.to_thread(
                    self._put_bucket_config, bucket, "encryption_xml", b""
                )
            if "replication" in q:
                # DeleteBucketReplicationConfigHandler role.
                return await asyncio.to_thread(
                    self._put_bucket_config, bucket, "replication_xml", b""
                )
            if "website" in q:
                # Dummy delete (cmd/dummy-handlers.go:165): succeed, no-op.
                await asyncio.to_thread(self.layer.get_bucket_info, bucket)
                return web.Response(status=200)
            return await asyncio.to_thread(self._delete_bucket, bucket)
        if m == "POST":
            if "delete" in q:
                return await asyncio.to_thread(self._bulk_delete, bucket, body, request)
            raise S3Error("MethodNotAllowed")
        raise S3Error("MethodNotAllowed")

    def _post_policy_upload(
        self, bucket: str, body: bytes, ctype: str, request: web.Request | None = None
    ) -> web.Response:
        """Browser POST upload with a signed policy document
        (PostPolicyBucketHandler, cmd/bucket-handlers.go equivalent)."""
        from . import postpolicy as pp

        form = pp.parse_multipart_form(body, ctype)
        if "file" not in form:
            raise S3Error("MalformedPOSTRequest", "missing file field")
        data = form["file"]
        access_key = pp.verify_post_signature(form, self.iam.lookup)
        policy = pp.PostPolicy.parse(base64.b64decode(form.get("policy", b"")))
        policy.check(form, len(data), bucket=bucket)
        key = form.get("key", b"").decode()
        if not key:
            raise S3Error("MalformedPOSTRequest", "missing key field")
        filename = form.get("__filename__", b"upload").decode() or "upload"
        key = key.replace("${filename}", filename)
        self._authorize(access_key, "s3:PutObject", bucket, key, request)
        self._check_quota(bucket, len(data))  # after auth: no quota-state leak
        meta = self.bucket_meta.get(bucket)
        user_defined = {
            k.lower(): v.decode("utf-8", "replace")
            for k, v in form.items()
            if k.lower().startswith("x-amz-meta-")
        }
        opts = PutObjectOptions(
            user_defined=user_defined,
            versioned=meta.versioning_enabled(),
            content_type=form.get("Content-Type", b"application/octet-stream").decode(),
            etag=hashlib.md5(data).hexdigest(),
        )
        if self.replication is not None:
            self.replication.mark_pending(bucket, key, user_defined)

        # Route through the same SSE/compression transforms as PUT, exposing
        # form fields as pseudo request headers (x-amz-server-side-encryption
        # et al.) so bucket-default SSE applies to browser uploads too.
        class _FormRequest:
            headers = {
                k.lower(): v.decode("utf-8", "replace")
                for k, v in form.items()
                if k not in ("file", "policy", "__filename__")
            }

        data = self._transform_put(bucket, key, data, _FormRequest(), opts)
        oi = self.layer.put_object(bucket, key, data, opts)
        self._emit("s3:ObjectCreated:Post", bucket, oi)
        status = form.get("success_action_status", b"204").decode()
        headers = {"ETag": f'"{oi.etag}"'}
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        if status == "201":
            return _xml(
                f'<PostResponse><Location>/{escape(bucket)}/{escape(key)}</Location>'
                f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
                f"<ETag>&quot;{oi.etag}&quot;</ETag></PostResponse>",
                201,
            )
        return web.Response(status=int(status) if status in ("200", "204") else 204, headers=headers)

    def _make_bucket(self, bucket: str, request: web.Request | None = None) -> web.Response:
        self.layer.make_bucket(bucket)
        meta = self.bucket_meta.get(bucket)
        if (
            request is not None
            and request.headers.get("x-amz-bucket-object-lock-enabled", "").lower() == "true"
        ):
            # Lock-enabled buckets are always versioned (AWS invariant).
            meta.versioning = "Enabled"
            meta.object_lock_xml = (
                "<ObjectLockConfiguration>"
                "<ObjectLockEnabled>Enabled</ObjectLockEnabled>"
                "</ObjectLockConfiguration>"
            )
        self.bucket_meta.save(meta)
        if self.site_repl is not None and self.site_repl.enabled:
            self.site_repl.on_bucket_make(bucket)
        return web.Response(status=200, headers={"Location": f"/{bucket}"})

    def _delete_bucket(self, bucket: str) -> web.Response:
        delete_bucket_with_hooks(
            self.layer, bucket,
            bucket_meta=self.bucket_meta,
            notification=self.peer_notification,
            site_repl=self.site_repl,
            notifier=self.notifier,
        )
        return web.Response(status=204)

    def _site_meta_sync(self, bucket: str) -> None:
        """Fan a bucket-metadata change out to peer sites (the reference
        calls the SRPeer meta RPC from every bucket-meta mutation)."""
        if self.site_repl is not None and self.site_repl.enabled:
            self.site_repl.on_bucket_meta(bucket)

    def _put_versioning(self, bucket: str, body: bytes) -> web.Response:
        self.layer.get_bucket_info(bucket)
        try:
            root = ET.fromstring(body)
            status = root.findtext(f"{{{XML_NS}}}Status") or root.findtext("Status") or ""
        except ET.ParseError:
            raise S3Error("MalformedXML")
        if status not in ("Enabled", "Suspended"):
            raise S3Error("MalformedXML")
        if status == "Suspended" and self.bucket_meta.get(bucket).object_lock_xml:
            raise S3Error(
                "InvalidBucketState",
                "versioning cannot be suspended on an object-lock enabled bucket",
            )
        if (
            status == "Suspended"
            and self.site_repl is not None
            and self.site_repl.enabled
        ):
            # Site replication requires versioned buckets everywhere (the
            # reference rejects suspension on site-replicated buckets too).
            raise S3Error(
                "InvalidBucketState",
                "versioning cannot be suspended on a site-replicated bucket",
            )
        self.bucket_meta.update(bucket, versioning=status)
        self._site_meta_sync(bucket)
        return web.Response(status=200)

    def _get_versioning(self, bucket: str) -> web.Response:
        self.layer.get_bucket_info(bucket)
        meta = self.bucket_meta.get(bucket)
        inner = f"<Status>{meta.versioning}</Status>" if meta.versioning else ""
        return _xml(f'<VersioningConfiguration xmlns="{XML_NS}">{inner}</VersioningConfiguration>')

    def _put_policy(self, bucket: str, body: bytes) -> web.Response:
        self.layer.get_bucket_info(bucket)
        try:
            pol = policy_mod.Policy.from_json(body)
        except Exception:
            raise S3Error("MalformedXML", "Policy is not valid JSON")
        try:
            pol.validate()  # unknown operators / bad CIDRs refuse at write
        except ValueError as e:
            raise S3Error("MalformedPolicy", str(e))
        self.bucket_meta.update(bucket, policy_json=body.decode())
        self._site_meta_sync(bucket)
        return web.Response(status=204)

    def _get_policy(self, bucket: str) -> web.Response:
        self.layer.get_bucket_info(bucket)
        meta = self.bucket_meta.get(bucket)
        if not meta.policy_json:
            raise S3Error("NoSuchBucketPolicy", resource=f"/{bucket}")
        return web.json_response(text=meta.policy_json)

    def _delete_policy(self, bucket: str) -> web.Response:
        self.layer.get_bucket_info(bucket)
        self.bucket_meta.update(bucket, policy_json="")
        self._site_meta_sync(bucket)
        return web.Response(status=204)

    def _put_bucket_tagging(self, bucket: str, body: bytes) -> web.Response:
        self.layer.get_bucket_info(bucket)
        tags: dict[str, str] = {}
        if body:
            try:
                root = ET.fromstring(body)
                for tag in root.iter():
                    if tag.tag.endswith("Tag"):
                        kv = {c.tag.split("}")[-1]: (c.text or "") for c in tag}
                        if "Key" in kv:
                            tags[kv["Key"]] = kv.get("Value", "")
            except ET.ParseError:
                raise S3Error("MalformedXML")
        self.bucket_meta.update(bucket, tagging=tags)
        self._site_meta_sync(bucket)
        return web.Response(status=200 if body else 204)

    def _get_bucket_tagging(self, bucket: str) -> web.Response:
        self.layer.get_bucket_info(bucket)
        meta = self.bucket_meta.get(bucket)
        if not meta.tagging:
            raise S3Error("NoSuchTagSet", resource=f"/{bucket}")
        tags = "".join(
            f"<Tag><Key>{escape(k)}</Key><Value>{escape(v)}</Value></Tag>"
            for k, v in meta.tagging.items()
        )
        return _xml(f'<Tagging xmlns="{XML_NS}"><TagSet>{tags}</TagSet></Tagging>')

    def _put_bucket_config(self, bucket: str, field: str, body: bytes) -> web.Response:
        self.layer.get_bucket_info(bucket)
        if body:
            try:
                ET.fromstring(body)
            except ET.ParseError:
                raise S3Error("MalformedXML")
        if (
            field == "replication_xml"
            and self.site_repl is not None
            and self.site_repl.enabled
        ):
            # Site replication owns this bucket's replication config (the
            # reference rejects edits on site-replicated buckets too).
            raise S3Error(
                "InvalidBucketState",
                "replication config is managed by site replication",
            )
        self.bucket_meta.update(bucket, **{field: body.decode() if body else ""})
        if field == "notification_xml" and self.notifier is not None:
            self.notifier.set_bucket_rules_from_xml(bucket, body)
        if field != "replication_xml":
            # replication config is per-site (it points at this site's
            # peers); everything else mirrors across sites.
            self._site_meta_sync(bucket)
        return web.Response(status=200 if body else 204)

    def _get_bucket_config(self, bucket: str, field: str, missing_code: str) -> web.Response:
        self.layer.get_bucket_info(bucket)
        meta = self.bucket_meta.get(bucket)
        raw = getattr(meta, field)
        if not raw:
            raise S3Error(missing_code, resource=f"/{bucket}")
        return web.Response(body=raw.encode(), content_type="application/xml")

    def _get_notification(self, bucket: str) -> web.Response:
        self.layer.get_bucket_info(bucket)
        meta = self.bucket_meta.get(bucket)
        if not meta.notification_xml:
            return _xml(f'<NotificationConfiguration xmlns="{XML_NS}"></NotificationConfiguration>')
        return web.Response(body=meta.notification_xml.encode(), content_type="application/xml")

    def _acl_xml(self) -> str:
        return (
            f'<AccessControlPolicy xmlns="{XML_NS}">'
            "<Owner><ID>minio-tpu</ID><DisplayName>minio-tpu</DisplayName></Owner>"
            "<AccessControlList><Grant>"
            '<Grantee xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" xsi:type="CanonicalUser">'
            "<ID>minio-tpu</ID><DisplayName>minio-tpu</DisplayName></Grantee>"
            "<Permission>FULL_CONTROL</Permission>"
            "</Grant></AccessControlList></AccessControlPolicy>"
        )

    def _head_for_acl(self, bucket: str, key: str) -> None:
        """Object-ACL subresources 404 like the object APIs do."""
        self.layer.get_bucket_info(bucket)
        self.layer.get_object_info(bucket, key)

    def _put_acl(
        self, bucket: str, request: web.Request, body: bytes, key: str = ""
    ) -> web.Response:
        """Put{Bucket,Object}ACLHandler role: buckets/objects are always
        owner-FULL_CONTROL; only the private canned ACL (or an ACL document
        granting exactly that) is accepted, anything else is NotImplemented
        (access control is IAM/bucket-policy driven, as in the reference)."""
        self.layer.get_bucket_info(bucket)
        if key:
            self.layer.get_object_info(bucket, key)
        canned = request.headers.get("x-amz-acl", "")
        if canned and canned != "private":
            raise S3Error("NotImplemented")
        if not canned and body:
            try:
                root = ET.fromstring(body)
            except ET.ParseError:
                raise S3Error("MalformedXML")
            grants = [g for g in root.iter() if g.tag.endswith("Grant")]
            perms = [
                (p.text or "") for g in grants for p in g.iter() if p.tag.endswith("Permission")
            ]
            if perms != ["FULL_CONTROL"]:
                raise S3Error("NotImplemented")
        return web.Response(status=200)

    def _get_policy_status(self, bucket: str) -> web.Response:
        """GetBucketPolicyStatusHandler: IsPublic = the stored bucket policy
        grants anonymous access (bucket policies are principal-* grants here,
        evaluated through the real engine so Deny/Condition nullification
        reports private)."""
        self.layer.get_bucket_info(bucket)
        meta = self.bucket_meta.get(bucket)
        public = False
        if meta.policy_json:
            try:
                pol = policy_mod.Policy.from_json(meta.policy_json)
                # Evaluate representative anonymous requests through the real
                # engine (deny-overrides + conditions), not a bare
                # any-Allow-statement scan -- a policy whose Allow is nullified
                # by a Deny or an unsatisfiable Condition is not public.
                public = any(
                    pol.is_allowed(action, resource)
                    for action, resource in (
                        ("s3:GetObject", f"arn:aws:s3:::{bucket}/*"),
                        ("s3:PutObject", f"arn:aws:s3:::{bucket}/*"),
                        ("s3:ListBucket", f"arn:aws:s3:::{bucket}"),
                    )
                )
            except Exception as e:  # noqa: BLE001 - malformed stored policy is not public
                GLOBAL_LOGGER.log_once(
                    f"bucket {bucket}: stored policy unparsable, treating as private: {e}",
                    key=f"policy-status-{bucket}",
                )
                public = False
        return _xml(
            f'<PolicyStatus xmlns="{XML_NS}">'
            f"<IsPublic>{'TRUE' if public else 'FALSE'}</IsPublic></PolicyStatus>"
        )

    def _replication_reset(self, bucket: str) -> web.Response:
        """ResetBucketReplicationStateHandler role: resync existing objects
        to every rule-enabled target (bucket-replication.go resync). A
        bucket with no replication config errors rather than silently
        queueing nothing, as the reference does."""
        self.layer.get_bucket_info(bucket)
        if self.replication is None:
            raise S3Error("NotImplemented")
        meta = self.bucket_meta.get(bucket)
        if not meta.replication_xml:
            raise S3Error("ReplicationConfigurationNotFoundError", resource=f"/{bucket}")
        n = self.replication.resync(bucket)
        return web.json_response({"queued": n})

    def _replication_metrics(self, bucket: str) -> web.Response:
        """GetBucketReplicationMetricsHandler role: live counters from the
        replication workers (bucket-replication.go stats)."""
        self.layer.get_bucket_info(bucket)
        if self.replication is None:
            raise S3Error("ReplicationConfigurationNotFoundError", resource=f"/{bucket}")
        st = self.replication.stats
        return web.json_response(
            {
                "completed": st.completed,
                "failed": st.failed,
                "replicated_bytes": st.replicated_bytes,
                "pending": self.replication.pending,
            }
        )

    async def _listen_notification(self, request: web.Request, bucket: str) -> web.StreamResponse:
        """Live NDJSON event stream (ListenNotificationHandler,
        cmd/listen-notification-handlers.go:31): merges the local listen hub
        with every peer's /listen stream (the reference subscribes peers via
        peer REST), filters by bucket / prefix / suffix / event-name
        patterns, and writes one JSON record per event until the client
        disconnects. Slow consumers drop events rather than block publishers
        (the reference's non-blocking send into a bounded channel)."""
        if self.notifier is None:
            raise S3Error("NotImplemented")
        from ..control.events import Rule
        from .streams import stream_hub_response

        q = request.rel_url.query
        names = [v for v in q.getall("events", []) if v] or ["s3:*"]
        rule = Rule(events=names, prefix=q.get("prefix", ""), suffix=q.get("suffix", ""))

        def to_line(record) -> str | None:
            recs = record.get("Records") or [{}]
            s3info = recs[0].get("s3", {})
            ev_bucket = s3info.get("bucket", {}).get("name", "")
            ev_key = s3info.get("object", {}).get("key", "")
            ev_name = record.get("EventName", "")
            if bucket and ev_bucket and ev_bucket != bucket:
                return None
            if not rule.matches(ev_name, ev_key):
                return None
            return json.dumps(record)

        peers = self.peer_notification
        return await stream_hub_response(
            request,
            self.notifier.listen_hub,
            to_line,
            peer_streams=(
                [p.listen_stream for p in peers.peers] if peers is not None else None
            ),
        )


    def _list_multipart_uploads(self, bucket: str, q) -> web.Response:
        uploads = self.layer.list_multipart_uploads(bucket, q.get("prefix", ""))
        items = "".join(
            f"<Upload><Key>{escape(u['object'])}</Key><UploadId>{u['upload_id']}</UploadId>"
            f"<Initiated>{_iso(u['initiated'])}</Initiated></Upload>"
            for u in uploads
        )
        return _xml(
            f'<ListMultipartUploadsResult xmlns="{XML_NS}">'
            f"<Bucket>{escape(bucket)}</Bucket><IsTruncated>false</IsTruncated>"
            f"{items}</ListMultipartUploadsResult>"
        )

    def _list_objects(self, bucket: str, q, request: web.Request | None = None) -> web.Response:
        if (
            request is not None
            and zipext.wants_extract(request.headers)
            and zipext.ZIP_SEP in q.get("prefix", "")
        ):
            return self._list_objects_in_zip(bucket, q, request)
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        url_enc = q.get("encoding-type") == "url"
        enc_tag = "<EncodingType>url</EncodingType>" if url_enc else ""
        v2 = q.get("list-type") == "2"
        if v2:
            token = q.get("continuation-token", "")
            marker = base64.b64decode(token).decode() if token else q.get("start-after", "")
        else:
            marker = q.get("marker", "")
        res = self.layer.list_objects(bucket, prefix, marker, delimiter, max_keys)
        contents = "".join(_obj_xml(o, url_enc) for o in res.objects)
        prefixes = "".join(
            f"<CommonPrefixes><Prefix>{_enc_key(p, url_enc)}</Prefix></CommonPrefixes>"
            for p in res.prefixes
        )
        if v2:
            next_token = (
                f"<NextContinuationToken>{base64.b64encode(res.next_marker.encode()).decode()}"
                "</NextContinuationToken>"
                if res.is_truncated
                else ""
            )
            return _xml(
                f'<ListBucketResult xmlns="{XML_NS}">'
                f"<Name>{escape(bucket)}</Name><Prefix>{_enc_key(prefix, url_enc)}</Prefix>"
                f"<KeyCount>{len(res.objects) + len(res.prefixes)}</KeyCount>"
                f"<MaxKeys>{max_keys}</MaxKeys>"
                f"<Delimiter>{_enc_key(delimiter, url_enc)}</Delimiter>"
                f"{enc_tag}"
                f"<IsTruncated>{'true' if res.is_truncated else 'false'}</IsTruncated>"
                f"{next_token}{contents}{prefixes}</ListBucketResult>"
            )
        next_marker = (
            f"<NextMarker>{_enc_key(res.next_marker, url_enc)}</NextMarker>"
            if res.is_truncated and delimiter
            else ""
        )
        return _xml(
            f'<ListBucketResult xmlns="{XML_NS}">'
            f"<Name>{escape(bucket)}</Name><Prefix>{_enc_key(prefix, url_enc)}</Prefix>"
            f"<Marker>{_enc_key(q.get('marker', ''), url_enc)}</Marker>"
            f"<MaxKeys>{max_keys}</MaxKeys>"
            f"<Delimiter>{_enc_key(delimiter, url_enc)}</Delimiter>"
            f"{enc_tag}"
            f"<IsTruncated>{'true' if res.is_truncated else 'false'}</IsTruncated>"
            f"{next_marker}{contents}{prefixes}</ListBucketResult>"
        )

    def _list_versions(self, bucket: str, q) -> web.Response:
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        url_enc = q.get("encoding-type") == "url"
        res = self.layer.list_object_versions(
            bucket,
            prefix,
            q.get("key-marker", ""),
            q.get("version-id-marker", ""),
            delimiter,
            max_keys,
        )
        entries = []
        for o in res.objects:
            vid = o.version_id or "null"
            if o.delete_marker:
                entries.append(
                    f"<DeleteMarker><Key>{_enc_key(o.name, url_enc)}</Key><VersionId>{vid}</VersionId>"
                    f"<IsLatest>{'true' if o.is_latest else 'false'}</IsLatest>"
                    f"<LastModified>{_iso(o.mod_time)}</LastModified></DeleteMarker>"
                )
            else:
                entries.append(
                    f"<Version><Key>{_enc_key(o.name, url_enc)}</Key><VersionId>{vid}</VersionId>"
                    f"<IsLatest>{'true' if o.is_latest else 'false'}</IsLatest>"
                    f"<LastModified>{_iso(o.mod_time)}</LastModified>"
                    f"<ETag>&quot;{o.etag}&quot;</ETag><Size>{_display_size(o)}</Size>"
                    f"<StorageClass>{o.storage_class}</StorageClass></Version>"
                )
        prefixes = "".join(
            f"<CommonPrefixes><Prefix>{_enc_key(p, url_enc)}</Prefix></CommonPrefixes>"
            for p in res.prefixes
        )
        enc_tag = "<EncodingType>url</EncodingType>" if url_enc else ""
        return _xml(
            f'<ListVersionsResult xmlns="{XML_NS}">'
            f"<Name>{escape(bucket)}</Name><Prefix>{_enc_key(prefix, url_enc)}</Prefix>"
            f"<MaxKeys>{max_keys}</MaxKeys>{enc_tag}"
            f"<IsTruncated>{'true' if res.is_truncated else 'false'}</IsTruncated>"
            f"{''.join(entries)}{prefixes}</ListVersionsResult>"
        )

    def _bulk_delete(self, bucket: str, body: bytes, request: web.Request | None = None) -> web.Response:
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        quiet = (root.findtext("Quiet") or root.findtext(f"{{{XML_NS}}}Quiet") or "").lower() == "true"
        objects: list[tuple[str, str]] = []
        for obj in root.iter():
            if obj.tag.split("}")[-1] == "Object":
                kv = {c.tag.split("}")[-1]: (c.text or "") for c in obj}
                if "Key" in kv:
                    objects.append((kv["Key"], kv.get("VersionId", "")))
        meta = self.bucket_meta.get(bucket)
        versioned = meta.versioning_enabled()

        # WORM: each versioned delete must pass the same object-lock check
        # as the single-object path (DeleteMultipleObjects shares
        # enforceRetentionForDeletion in the reference).
        locked_errors: dict[tuple[str, str], S3Error] = {}
        if meta.object_lock_xml:
            bypass = bool(
                request is not None
                and request.headers.get("x-amz-bypass-governance-retention", "").lower() == "true"
            )
            may_bypass = False
            if request is not None and bypass:
                ak = request.get("access_key", "")
                may_bypass = bool(ak) and self.iam.is_allowed(
                    ak, "s3:BypassGovernanceRetention",
                    policy_mod.resource_arn(bucket, "*"),
                    self._policy_context(request),
                )
            survivors = []
            for name, vid in objects:
                if vid:
                    try:
                        oi = self.layer.get_object_info(bucket, name, GetObjectOptions(vid))
                        ol.check_delete_allowed(oi.user_defined, bypass, may_bypass)
                    except S3Error as e:
                        locked_errors[(name, vid)] = e
                        continue
                    except oerr.StorageError:
                        pass  # missing objects fall through to the layer
                survivors.append((name, vid))
            objects_to_delete = survivors
        else:
            objects_to_delete = objects
        tier_metas: dict[tuple[str, str], dict] = {}
        if self.tiering is not None:
            for name, vid in objects_to_delete:
                if not vid and versioned:
                    continue  # marker creation keeps the data
                try:
                    probe = self.layer.get_object_info(bucket, name, GetObjectOptions(vid))
                    if tiering_mod.is_transitioned(probe.internal):
                        tier_metas[(name, vid)] = probe.internal
                except oerr.StorageError:
                    pass
        results_by_obj = dict(
            zip(
                objects_to_delete,
                self.layer.delete_objects(bucket, objects_to_delete, versioned=versioned),
            )
        )
        # Journal tier reclamation only for deletes that actually succeeded.
        for okey, (oi_res, err_res) in results_by_obj.items():
            if err_res is None and okey in tier_metas:
                self.tiering.journal_delete(tier_metas[okey])
        results = [
            results_by_obj.get((name, vid), (None, locked_errors.get((name, vid))))
            for name, vid in objects
        ]
        parts = []
        for (name, vid), (oi, err) in zip(objects, results):
            # Replication + notification see every successful bulk delete,
            # same as the single-object path (the reference fans out events
            # from DeleteMultipleObjectsHandler too).
            if err is None and oi is not None:
                self._emit("s3:ObjectRemoved:Delete", bucket, oi)
            if isinstance(err, S3Error):
                parts.append(
                    f"<Error><Key>{escape(name)}</Key><Code>{err.code}</Code>"
                    f"<Message>{escape(err.message)}</Message></Error>"
                )
                continue
            if err is None:
                if not quiet:
                    parts.append(f"<Deleted><Key>{escape(name)}</Key></Deleted>")
            else:
                s3e = from_object_error(err, bucket, name)
                parts.append(
                    f"<Error><Key>{escape(name)}</Key><Code>{s3e.code}</Code>"
                    f"<Message>{escape(s3e.message)}</Message></Error>"
                )
        return _xml(f'<DeleteResult xmlns="{XML_NS}">{"".join(parts)}</DeleteResult>')

    # -- object ---------------------------------------------------------------

    async def _object_op(
        self, request: web.Request, bucket: str, key: str, body: bytes
    ) -> web.Response:
        m = request.method
        q = request.rel_url.query
        if m == "POST":
            if "select" in q and q.get("select-type") == "2":
                return await asyncio.to_thread(self._select_object, bucket, key, body, request)
            if "uploads" in q:
                return await asyncio.to_thread(self._initiate_multipart, bucket, key, request)
            if "uploadId" in q:
                return await asyncio.to_thread(
                    self._complete_multipart, bucket, key, q["uploadId"], body
                )
            if "restore" in q:
                return await asyncio.to_thread(self._restore_object, bucket, key, q, body)
            raise S3Error("MethodNotAllowed")
        if m == "PUT":
            if "tagging" in q:
                return await asyncio.to_thread(self._put_object_tagging, bucket, key, q, body)
            if "retention" in q:
                return await asyncio.to_thread(
                    self._put_object_retention, bucket, key, q, body, request
                )
            if "legal-hold" in q:
                return await asyncio.to_thread(
                    self._put_object_legal_hold, bucket, key, q, body
                )
            if "uploadId" in q and "partNumber" in q:
                if "x-amz-copy-source" in request.headers:
                    # UploadPartCopy (CopyObjectPartHandler equivalent).
                    return await asyncio.to_thread(
                        self._upload_part_copy,
                        bucket, key, q["uploadId"], int(q["partNumber"]), request,
                    )
                return await asyncio.to_thread(
                    self._upload_part, bucket, key, q["uploadId"], int(q["partNumber"]), body
                )
            if "acl" in q:
                # PutObjectACLHandler role: only the private default sticks.
                return await asyncio.to_thread(self._put_acl, bucket, request, body, key)
            if "x-amz-copy-source" in request.headers:
                return await asyncio.to_thread(self._copy_object, bucket, key, request)
            return await asyncio.to_thread(self._put_object, bucket, key, body, request)
        if m == "GET" and "acl" in q:
            await asyncio.to_thread(self._head_for_acl, bucket, key)
            return _xml(self._acl_xml())
        if m == "GET" and "uploadId" in q:
            return await asyncio.to_thread(self._list_parts, bucket, key, q)
        if m == "GET" and "tagging" in q:
            return await asyncio.to_thread(self._get_object_tagging, bucket, key, q)
        if m == "GET" and "attributes" in q:
            return await asyncio.to_thread(self._get_object_attributes, bucket, key, request)
        if m == "GET" and "retention" in q:
            return await asyncio.to_thread(self._get_object_retention, bucket, key, q)
        if m == "GET" and "legal-hold" in q:
            return await asyncio.to_thread(self._get_object_legal_hold, bucket, key, q)
        if m in ("GET", "HEAD"):
            if zipext.wants_extract(request.headers) and zipext.split_zip_path(key):
                return await asyncio.to_thread(
                    self._get_object_in_zip, bucket, key, request, m == "HEAD"
                )
            resp = await asyncio.to_thread(self._get_object, bucket, key, request, m == "HEAD")
            if isinstance(resp, _StreamPlan):
                return await self._send_stream(request, resp)
            return resp
        if m == "DELETE":
            if "tagging" in q:
                return await asyncio.to_thread(self._delete_object_tagging, bucket, key, q)
            if "uploadId" in q:
                return await asyncio.to_thread(self._abort_multipart, bucket, key, q["uploadId"])
            return await asyncio.to_thread(self._delete_object, bucket, key, q, request)
        raise S3Error("MethodNotAllowed")

    # -- multipart ------------------------------------------------------------

    def _initiate_multipart(self, bucket: str, key: str, request: web.Request) -> web.Response:
        opts = self._put_opts(bucket, request, key)
        upload_id = self.layer.new_multipart_upload(bucket, key, opts)
        return _xml(
            f'<InitiateMultipartUploadResult xmlns="{XML_NS}">'
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId></InitiateMultipartUploadResult>"
        )

    def _upload_part(
        self, bucket: str, key: str, upload_id: str, part_number: int, body: bytes
    ) -> web.Response:
        if isinstance(body, (bytes, bytearray)):
            self._check_quota(bucket, len(body))
        part = self.layer.put_object_part(bucket, key, upload_id, part_number, body)
        return web.Response(status=200, headers={"ETag": f'"{part.etag}"'})

    def _upload_part_copy(
        self, bucket: str, key: str, upload_id: str, part_number: int,
        request: web.Request,
    ) -> web.Response:
        """UploadPartCopy: a part sourced from an existing object, with
        optional x-amz-copy-source-range (CopyObjectPartHandler role)."""
        _, data = self._resolve_copy_source(request)
        rng = request.headers.get("x-amz-copy-source-range", "")
        if rng:
            m = re.fullmatch(r"bytes=(\d+)-(\d+)", rng.strip())
            if not m:
                raise S3Error("InvalidArgument", "bad x-amz-copy-source-range")
            lo, hi = int(m.group(1)), int(m.group(2))
            # The whole range must lie inside the source (the reference's
            # errInvalidRangeSource): silent truncation would assemble a
            # short object with a 200.
            if lo > hi or hi >= len(data):
                raise S3Error("InvalidRange", resource=f"/{bucket}/{key}")
            data = data[lo : hi + 1]
        self._check_quota(bucket, len(data))
        part = self.layer.put_object_part(bucket, key, upload_id, part_number, data)
        return _xml(
            f'<CopyPartResult xmlns="{XML_NS}">'
            f"<LastModified>{_iso(part.mod_time)}</LastModified>"
            f"<ETag>&quot;{part.etag}&quot;</ETag></CopyPartResult>"
        )

    def _list_parts(self, bucket: str, key: str, q) -> web.Response:
        upload_id = q["uploadId"]
        marker = int(q.get("part-number-marker", "0"))
        max_parts = int(q.get("max-parts", "1000"))
        parts = self.layer.list_parts(bucket, key, upload_id, marker, max_parts)
        items = "".join(
            f"<Part><PartNumber>{p.number}</PartNumber><ETag>&quot;{p.etag}&quot;</ETag>"
            f"<Size>{p.size}</Size><LastModified>{_iso(p.mod_time)}</LastModified></Part>"
            for p in parts
        )
        return _xml(
            f'<ListPartsResult xmlns="{XML_NS}">'
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId><IsTruncated>false</IsTruncated>"
            f"{items}</ListPartsResult>"
        )

    def _complete_multipart(
        self, bucket: str, key: str, upload_id: str, body: bytes
    ) -> web.Response:
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        parts: list[tuple[int, str]] = []
        for el in root.iter():
            if el.tag.split("}")[-1] == "Part":
                kv = {c.tag.split("}")[-1]: (c.text or "") for c in el}
                try:
                    parts.append((int(kv["PartNumber"]), kv["ETag"].strip()))
                except (KeyError, ValueError):
                    raise S3Error("MalformedXML")
        oi = self.layer.complete_multipart_upload(bucket, key, upload_id, parts)
        self._emit("s3:ObjectCreated:CompleteMultipartUpload", bucket, oi)
        headers = {}
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        resp = _xml(
            f'<CompleteMultipartUploadResult xmlns="{XML_NS}">'
            f"<Location>/{escape(bucket)}/{escape(key)}</Location>"
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<ETag>&quot;{oi.etag}&quot;</ETag></CompleteMultipartUploadResult>"
        )
        resp.headers.update(headers)
        return resp

    def _abort_multipart(self, bucket: str, key: str, upload_id: str) -> web.Response:
        self.layer.abort_multipart_upload(bucket, key, upload_id)
        return web.Response(status=204)

    def _put_opts(self, bucket: str, request: web.Request, key: str = "") -> PutObjectOptions:
        meta = self.bucket_meta.get(bucket)
        user_defined = {
            k.lower(): v
            for k, v in request.headers.items()
            if k.lower().startswith("x-amz-meta-")
        }
        for h in ("cache-control", "content-disposition", "content-encoding", "content-language"):
            if h in request.headers:
                user_defined[h] = request.headers[h]
        # Object tags supplied at upload time (x-amz-tagging, query-encoded).
        if "x-amz-tagging" in request.headers:
            tags = urllib.parse.parse_qsl(
                request.headers["x-amz-tagging"], keep_blank_values=True
            )
            if len(tags) > 10:
                raise S3Error("InvalidArgument", "at most 10 tags per object")
            user_defined[self.TAGS_META] = urllib.parse.urlencode(tags)
        # Object lock headers / bucket default retention.
        lock_cfg = ol.LockConfig.from_xml(meta.object_lock_xml)
        mode = request.headers.get("x-amz-object-lock-mode", "").upper()
        until = request.headers.get("x-amz-object-lock-retain-until-date", "")
        hold = request.headers.get("x-amz-object-lock-legal-hold", "").upper()
        if mode or until or hold:
            if not lock_cfg.enabled:
                raise S3Error(
                    "InvalidRequest", "bucket is missing object lock configuration"
                )
        if mode or until:
            if not mode or not until or mode not in ol.MODES:
                raise S3Error("InvalidArgument", "both lock mode and retain-until required")
            try:
                if ol.parse_iso(until) <= datetime.datetime.now(datetime.timezone.utc):
                    raise S3Error("InvalidArgument", "retain-until date must be in the future")
            except ValueError:
                raise S3Error("InvalidArgument", "bad retain-until date")
            user_defined[ol.META_MODE] = mode
            user_defined[ol.META_RETAIN_UNTIL] = until
        elif lock_cfg.enabled:
            user_defined.update(lock_cfg.default_retention_meta(_time.time()))
        if hold:
            if hold not in ("ON", "OFF"):
                raise S3Error("InvalidArgument", "bad legal hold status")
            user_defined[ol.META_LEGAL_HOLD] = hold
        sc = request.headers.get("x-amz-storage-class", "").upper()
        if sc and sc not in ("STANDARD", "REDUCED_REDUNDANCY"):
            raise S3Error("InvalidStorageClass")
        opts = PutObjectOptions(
            user_defined=user_defined,
            versioned=meta.versioning_enabled(),
            content_type=request.headers.get("Content-Type", "application/octet-stream"),
            storage_class=sc,
        )
        # Replica writes from a source cluster: preserve version identity and
        # mark REPLICA so this object is never re-replicated (the reference's
        # X-Minio-Source-* handling in object-handlers.go putOpts).
        from ..control import replication as repl_mod

        if request.headers.get(repl_mod.HDR_SOURCE_REPL, "") == "true":
            # Only a principal holding s3:ReplicateObject may write replicas
            # (the reference gates X-Minio-Source-* behind the replication
            # permission; otherwise any writer could forge REPLICA status or
            # overwrite an arbitrary version id in place).
            ak = request.get("access_key", "")
            if not ak or not self.iam.is_allowed(
                ak, "s3:ReplicateObject", policy_mod.resource_arn(bucket, key),
                self._policy_context(request),
            ):
                raise S3Error("AccessDenied", "replication permission required")
            user_defined[repl_mod.META_REPLICA_STATUS] = repl_mod.REPLICA
            src_vid = request.headers.get(repl_mod.HDR_SOURCE_VID, "")
            if src_vid and opts.versioned:
                opts.version_id = src_vid
        elif self.replication is not None:
            self.replication.mark_pending(bucket, key, user_defined)
        return opts

    # -- SSE / compression transforms (encryption-v1.go + compression role) --

    def _parse_ssec_key(self, request: web.Request, prefix: str = "") -> bytes | None:
        algo = request.headers.get(f"x-amz-{prefix}server-side-encryption-customer-algorithm", "")
        if not algo:
            return None
        if algo != "AES256":
            raise S3Error("NotImplemented", "only AES256 SSE-C")
        key = base64.b64decode(
            request.headers.get(f"x-amz-{prefix}server-side-encryption-customer-key", "")
        )
        md5_b64 = request.headers.get(
            f"x-amz-{prefix}server-side-encryption-customer-key-md5", ""
        )
        if md5_b64 and base64.b64encode(hashlib.md5(key).digest()).decode() != md5_b64:
            raise S3Error("InvalidDigest", "SSE-C key MD5 mismatch")
        if len(key) != 32:
            raise S3Error("InvalidArgument", "SSE-C key must be 256 bits")
        return key

    def _bucket_default_sse(self, bucket: str) -> bool:
        meta = self.bucket_meta.get(bucket)
        return bool(meta.encryption_xml) and "AES256" in meta.encryption_xml

    def _transform_put(
        self, bucket: str, key: str, body: bytes, request: web.Request, opts: PutObjectOptions
    ) -> bytes:
        """Apply compression then encryption; records internal metadata."""
        from ..control import compress as compress_mod
        from ..control import crypto as crypto_mod

        ssec_key = self._parse_ssec_key(request)
        wants_sse_s3 = (
            request.headers.get("x-amz-server-side-encryption", "") in ("AES256", "aws:kms")
            or self._bucket_default_sse(bucket)
        )
        compression_on = self._compression_on()
        if compression_on and compress_mod.is_compressible(key, opts.content_type):
            body, cmeta = compress_mod.compress(body)
            opts.user_defined.update(cmeta)
        def merge_sse_meta(res_metadata: dict) -> None:
            # Compression (above) already recorded the ORIGINAL actual
            # size; the SSE layer's view of "actual" is the compressed
            # length and must not clobber it — every metadata consumer
            # (listing Size, events, GetObjectAttributes) would report the
            # compressed size for compress+SSE objects.
            prior = opts.user_defined.get(crypto_mod.META_ACTUAL_SIZE)
            opts.user_defined.update(res_metadata)
            if prior is not None:
                opts.user_defined[crypto_mod.META_ACTUAL_SIZE] = prior

        if ssec_key is not None:
            res = crypto_mod.sse_c_encrypt(body, ssec_key, bucket, key)
            merge_sse_meta(res.metadata)
            return res.data
        if wants_sse_s3:
            if self.kms is None:
                raise S3Error("NotImplemented", "no KMS configured")
            res = crypto_mod.sse_s3_encrypt(body, self.kms, bucket, key)
            merge_sse_meta(res.metadata)
            return res.data
        return body

    def _transform_get(
        self, bucket: str, key: str, data: bytes, oi: ObjectInfo, request: web.Request,
        ssec_prefix: str = "",
    ) -> bytes:
        """ssec_prefix selects which SSE-C header family carries the key:
        "" for GET/HEAD, "copy-source-" when the caller is reading an
        x-amz-copy-source (whose key travels in the
        x-amz-copy-source-server-side-encryption-customer-* headers, NOT
        the destination's)."""
        from ..control import compress as compress_mod
        from ..control import crypto as crypto_mod

        algo = crypto_mod.is_encrypted(oi.internal)
        if algo == crypto_mod.ALGO_SSE_C:
            client_key = self._parse_ssec_key(request, prefix=ssec_prefix)
            if client_key is None:
                raise S3Error("InvalidRequest", "object is SSE-C encrypted; key required")
            data = crypto_mod.sse_c_decrypt(data, oi.internal, client_key, bucket, key)
        elif algo == crypto_mod.ALGO_SSE_S3:
            if self.kms is None:
                raise S3Error("InternalError", "no KMS to decrypt")
            data = crypto_mod.sse_s3_decrypt(data, oi.internal, self.kms, bucket, key)
        if compress_mod.is_compressed(oi.internal):
            data = compress_mod.decompress(data, oi.internal)
        return data

    @staticmethod
    def _is_transformed(oi: ObjectInfo) -> bool:
        from ..control import compress as compress_mod
        from ..control import crypto as crypto_mod

        return bool(crypto_mod.is_encrypted(oi.internal)) or compress_mod.is_compressed(oi.internal)

    @staticmethod
    def _logical_size(oi: ObjectInfo) -> int:
        return _display_size(oi)

    def _sse_response_headers(self, oi: ObjectInfo) -> dict[str, str]:
        from ..control import crypto as crypto_mod

        algo = crypto_mod.is_encrypted(oi.internal)
        if algo == crypto_mod.ALGO_SSE_S3:
            return {"x-amz-server-side-encryption": "AES256"}
        if algo == crypto_mod.ALGO_SSE_C:
            return {
                "x-amz-server-side-encryption-customer-algorithm": "AES256",
            }
        return {}

    def _put_needs_transform(
        self, bucket: str, key: str, request: web.Request, opts: PutObjectOptions
    ) -> bool:
        """True when the payload must be buffered for SSE/compression."""
        from ..control import compress as compress_mod

        if self._parse_ssec_key(request) is not None:
            return True
        if (
            request.headers.get("x-amz-server-side-encryption", "") in ("AES256", "aws:kms")
            or self._bucket_default_sse(bucket)
        ):
            return True
        compression_on = self._compression_on()
        return compression_on and compress_mod.is_compressible(key, opts.content_type)

    def _compression_on(self) -> bool:
        """Whether the compression config (control/config.py) is on; a
        config that cannot be read means off, as in the JAX front."""
        if self.config is None:
            return False
        try:
            from ..control.config import SUBSYS_COMPRESSION

            return self.config.get_bool(SUBSYS_COMPRESSION, "enable")
        except Exception as e:  # noqa: BLE001 - config read failure = feature off
            GLOBAL_LOGGER.log_once(
                f"compression config unreadable, treating as disabled: {e}",
                key="compression-config",
            )
            return False

    def _check_quota(self, bucket: str, incoming: int) -> None:
        """Hard bucket quota (enforceBucketQuota, cmd/bucket-quota.go:112):
        enforced only when the bucket has a quota set AND a usage source is
        wired. The source returns the bucket's scanned usage in bytes, or
        None when NO usage information exists yet (no scan has completed
        cluster-wide) -- in that case enforcement is skipped, as the
        reference does when the bucket has no usage entry."""
        meta = self.bucket_meta.get(bucket)
        if meta.quota <= 0 or self.quota_usage is None:
            return
        # An object at least quota-sized can never fit regardless of how
        # much is already used -- reject it even before any scan has run.
        if incoming >= meta.quota:
            raise S3Error("XMinioAdminBucketQuotaExceeded", resource=f"/{bucket}")
        try:
            used = self.quota_usage(bucket)
        except Exception as e:  # noqa: BLE001 - usage source down != reject writes
            GLOBAL_LOGGER.log_once(
                f"quota usage source failed for {bucket}, skipping enforcement: {e}",
                key=f"quota-usage-{bucket}",
            )
            return
        if used is None:
            return
        if used + incoming >= meta.quota:
            raise S3Error("XMinioAdminBucketQuotaExceeded", resource=f"/{bucket}")

    def _put_object(self, bucket: str, key: str, data, request: web.Request) -> web.Response:
        """data: a verified streaming reader (dispatch) or bytes (legacy).

        Untransformed payloads stream straight into the erasure pipeline;
        SSE/compression still buffer (streaming transforms are the remaining
        gap vs the reference's fully piped chain)."""
        if isinstance(data, (bytes, bytearray)):
            self._check_quota(bucket, len(data))
        # (streaming readers were quota-checked at dispatch with the decoded
        # content length, _streaming_put_entry)
        opts = self._put_opts(bucket, request, key)
        body: bytes | bytearray | None = None
        if isinstance(data, (bytes, bytearray)):
            body = data  # consumed in place -- no defensive copy of the payload
            if len(body) > MAX_OBJECT_SIZE:
                raise S3Error("EntityTooLarge")
            if "Content-Md5" in request.headers:
                want = base64.b64decode(request.headers["Content-Md5"])
                if hashlib.md5(body).digest() != want:
                    raise S3Error("BadDigest")
        elif self._put_needs_transform(bucket, key, request, opts) or not getattr(
            self.layer, "supports_streaming", False
        ):
            body = _read_all(data)  # reader enforces limit + digests
        if body is not None:
            opts.etag = hashlib.md5(body).hexdigest()
            payload = self._transform_put(bucket, key, body, request, opts)
            oi = self.layer.put_object(bucket, key, payload, opts)
        else:
            # A declared Content-MD5 pins the etag up front (the reader
            # verifies the digest at EOF and aborts the PUT on mismatch);
            # otherwise the erasure layer's streaming etag applies.
            want_md5 = request.headers.get("Content-Md5", "")
            if want_md5 and not opts.etag:
                try:
                    opts.etag = base64.b64decode(want_md5).hex()
                except (ValueError, TypeError):
                    raise S3Error("InvalidDigest")
            oi = self.layer.put_object(bucket, key, data, opts)
        headers = {"ETag": f'"{oi.etag}"'}
        headers.update(self._sse_response_headers(oi))
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        self._emit("s3:ObjectCreated:Put", bucket, oi)
        return web.Response(status=200, headers=headers)

    def _resolve_copy_source(self, request: web.Request):
        """Fetch + precondition-check the x-amz-copy-source object.

        Shared by CopyObject and UploadPartCopy; enforces the
        x-amz-copy-source-if-{match,none-match,modified-since,
        unmodified-since} conditions (the reference's
        checkCopyObjectPreconditions, cmd/object-handlers-common.go)."""
        src = urllib.parse.unquote(request.headers["x-amz-copy-source"])
        if src.startswith("/"):
            src = src[1:]
        vid = ""
        if "?versionId=" in src:
            src, vid = src.split("?versionId=", 1)
        if "/" not in src:
            raise S3Error("InvalidArgument", "bad copy source")
        src_bucket, src_key = src.split("/", 1)

        def pre_check(probe: ObjectInfo) -> None:
            # Copy preconditions against metadata only, before any data IO
            # or tier recall. BOTH outcomes are 412 on CopyObject (no 304).
            if _rfc7232_outcome(
                request.headers, probe.etag, probe.mod_time,
                prefix="x-amz-copy-source-if-",
            ) is not None:
                raise S3Error("PreconditionFailed", resource=f"/{src_bucket}/{src_key}")

        # Logical bytes, tiered recall included; the SSE-C source key
        # arrives in the copy-source header family. The destination
        # re-applies its own transforms via _transform_put.
        return self._read_logical(
            src_bucket, src_key, request, vid,
            ssec_prefix="copy-source-", pre_check=pre_check,
        )

    def _copy_object(self, bucket: str, key: str, request: web.Request) -> web.Response:
        src_oi, data = self._resolve_copy_source(request)
        self._check_quota(bucket, len(data))
        opts = self._put_opts(bucket, request, key)
        if request.headers.get("x-amz-metadata-directive", "COPY") == "COPY":
            opts.user_defined = dict(src_oi.user_defined)
            # A restored-from-tier source's x-amz-restore stamp must not
            # travel: the destination is a plain local object, and a stale
            # stamp would later convince the tiering reader a restored
            # copy exists (S3 strips it on copy too).
            opts.user_defined.pop(tiering_mod.META_RESTORE, None)
            opts.content_type = src_oi.content_type
            # COPY directive replaced user_defined; re-mark for replication
            # (src metadata never carries internal replication keys).
            if self.replication is not None:
                self.replication.mark_pending(bucket, key, opts.user_defined)
        # The destination gets its own transforms (bucket-default SSE,
        # compression filters, x-amz-server-side-encryption on the COPY
        # request), exactly as a fresh PUT of the logical bytes would —
        # including the PUT path's etag-of-logical-bytes semantics.
        opts.etag = hashlib.md5(data).hexdigest()
        data = self._transform_put(bucket, key, data, request, opts)
        oi = self.layer.put_object(bucket, key, data, opts)
        self._emit("s3:ObjectCreated:Copy", bucket, oi)
        return _xml(
            f'<CopyObjectResult xmlns="{XML_NS}">'
            f"<LastModified>{_iso(oi.mod_time)}</LastModified>"
            f"<ETag>&quot;{oi.etag}&quot;</ETag></CopyObjectResult>"
        )

    def _object_headers(self, oi: ObjectInfo) -> dict[str, str]:
        headers = {
            "ETag": f'"{oi.etag}"',
            "Last-Modified": _http_date(oi.mod_time),
            "Content-Type": oi.content_type,
            "Accept-Ranges": "bytes",
        }
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        for k, v in oi.user_defined.items():
            headers[k] = v
        raw_tags = oi.internal.get(self.TAGS_META, "")
        if raw_tags:
            headers["x-amz-tagging-count"] = str(
                len(urllib.parse.parse_qsl(raw_tags, keep_blank_values=True))
            )
        from ..control import replication as repl_mod

        repl_status = oi.internal.get(repl_mod.META_REPL_STATUS, "") or oi.internal.get(
            repl_mod.META_REPLICA_STATUS, ""
        )
        if repl_status:
            headers["x-amz-replication-status"] = repl_status
        if tiering_mod.is_transitioned(oi.internal):
            # Listings/HEAD show the tier name as the storage class, like the
            # reference does for transitioned objects.
            headers["x-amz-storage-class"] = oi.internal.get(
                tiering_mod.META_TRANSITION_TIER, "GLACIER"
            )
        elif oi.storage_class and oi.storage_class != "STANDARD":
            headers["x-amz-storage-class"] = oi.storage_class
        return headers

    # -- zip extension (s3-zip-handlers.go role) ------------------------------

    def _read_logical(
        self, bucket: str, key: str, request: web.Request, vid: str = "",
        ssec_prefix: str = "", pre_check=None,
    ) -> tuple[ObjectInfo, bytes]:
        """Whole object in LOGICAL bytes: tiered versions recalled from
        their remote tier, transforms (SSE/compression) undone — the read
        every non-streaming consumer (Select, zip extraction, copy source)
        must share, or each grows its own 5xx-on-tiered / raw-bytes bug.

        pre_check(probe) runs against metadata BEFORE any data IO, so
        callers with preconditions (copy's if-match) never pay a tier
        recall just to discard it."""
        opts = GetObjectOptions(vid)
        probe = self.layer.get_object_info(bucket, key, opts)
        if pre_check is not None:
            pre_check(probe)
        if self.tiering is not None and tiering_mod.is_transitioned(probe.internal):
            data = self.tiering.read_object(self.layer, bucket, key, probe)
            oi = probe
        else:
            oi, data = self.layer.get_object(bucket, key, opts)
        return oi, self._transform_get(
            bucket, key, data, oi, request, ssec_prefix=ssec_prefix
        )

    def _read_zip_archive(self, bucket: str, zip_key: str, request: web.Request) -> bytes:
        """Whole archive in logical bytes."""
        return self._read_logical(bucket, zip_key, request)[1]

    def _get_object_in_zip(
        self, bucket: str, key: str, request: web.Request, head: bool
    ) -> web.Response:
        zip_key, inner = zipext.split_zip_path(key)
        if not inner:
            raise S3Error("NoSuchKey", resource=f"/{bucket}/{key}")
        data = self._read_zip_archive(bucket, zip_key, request)
        try:
            if head:
                # HEAD reads only central-directory metadata — no payload
                # decompression.
                entry, payload = zipext.stat_entry(data, inner), None
            else:
                found = zipext.read_entry(data, inner)
                entry, payload = found if found is not None else (None, None)
        except Exception:
            raise S3Error("InvalidRequest", "object is not a valid zip archive")
        if entry is None:
            raise S3Error("NoSuchKey", resource=f"/{bucket}/{key}")
        headers = {
            "ETag": f'"{entry.etag}"',
            "Last-Modified": _http_date(entry.mod_time),
            "Content-Type": zipext.content_type(entry.name),
            "Accept-Ranges": "bytes",
        }
        if head:
            headers["Content-Length"] = str(entry.size)
            return web.Response(status=200, headers=headers)
        rng = request.headers.get("Range", "")
        if rng:
            offset, length, _ = _parse_range(rng)
            if offset < 0:  # suffix range: last N bytes
                offset = max(len(payload) + offset, 0)
            if offset >= len(payload) or not payload:
                raise S3Error("InvalidRange", resource=f"/{bucket}/{key}")
            end = len(payload) if length < 0 else min(offset + length, len(payload))
            part = payload[offset:end]
            headers["Content-Range"] = f"bytes {offset}-{end - 1}/{len(payload)}"
            return web.Response(status=206, body=part, headers=headers)
        return web.Response(status=200, body=payload, headers=headers)

    def _list_objects_in_zip(self, bucket: str, q, request: web.Request) -> web.Response:
        prefix = q.get("prefix", "")
        zip_key, inner_prefix = zipext.split_zip_path(prefix)
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        v2 = q.get("list-type") == "2"
        if v2:
            token = q.get("continuation-token", "")
            marker = base64.b64decode(token).decode() if token else q.get("start-after", "")
        else:
            marker = q.get("marker", "")

        # Real request headers flow through so SSE-C keys reach the decrypt
        # path for encrypted archives.
        data = self._read_zip_archive(bucket, zip_key, request)
        try:
            entries = zipext.list_entries(data)
        except Exception:
            raise S3Error("InvalidRequest", "object is not a valid zip archive")

        # One merged, name-ordered stream of keys and rolled-up common
        # prefixes; marker/truncation apply uniformly to both so pagination
        # never duplicates or drops a prefix group.
        items: list[tuple[str, zipext.ZipEntry | None]] = []
        seen_prefix: set[str] = set()
        for e in sorted(entries, key=lambda x: x.name):
            if not e.name.startswith(inner_prefix):
                continue
            if delimiter:
                rest = e.name[len(inner_prefix):]
                cut = rest.find(delimiter)
                if cut >= 0:
                    p = f"{zip_key}/{inner_prefix}{rest[: cut + len(delimiter)]}"
                    if p not in seen_prefix:
                        seen_prefix.add(p)
                        if not (marker and p <= marker):
                            items.append((p, None))
                    continue
            full = f"{zip_key}/{e.name}"
            if marker and full <= marker:
                continue
            items.append((full, e))
        truncated = len(items) > max_keys
        items = items[:max_keys]
        contents = "".join(
            f"<Contents><Key>{escape(name)}</Key>"
            f"<LastModified>{_iso(e.mod_time)}</LastModified>"
            f'<ETag>"{e.etag}"</ETag><Size>{e.size}</Size>'
            "<StorageClass>STANDARD</StorageClass></Contents>"
            for name, e in items
            if e is not None
        )
        cps = "".join(
            f"<CommonPrefixes><Prefix>{escape(name)}</Prefix></CommonPrefixes>"
            for name, e in items
            if e is None
        )
        last = items[-1][0] if items else ""
        common = (
            f"<Name>{escape(bucket)}</Name><Prefix>{escape(prefix)}</Prefix>"
            f"<MaxKeys>{max_keys}</MaxKeys><Delimiter>{escape(delimiter)}</Delimiter>"
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
        )
        if v2:
            next_token = (
                f"<NextContinuationToken>{base64.b64encode(last.encode()).decode()}"
                "</NextContinuationToken>"
                if truncated
                else ""
            )
            return _xml(
                f'<ListBucketResult xmlns="{XML_NS}">{common}'
                f"<KeyCount>{len(items)}</KeyCount>{next_token}{contents}{cps}"
                "</ListBucketResult>"
            )
        next_marker = (
            f"<NextMarker>{escape(last)}</NextMarker>" if truncated else ""
        )
        return _xml(
            f'<ListBucketResult xmlns="{XML_NS}">{common}'
            f"<Marker>{escape(marker)}</Marker>{next_marker}{contents}{cps}"
            "</ListBucketResult>"
        )

    def _get_object(
        self, bucket: str, key: str, request: web.Request, head: bool
    ) -> web.Response:
        vid = request.rel_url.query.get("versionId", "")
        if vid == "null":
            vid = ""
        opts = GetObjectOptions(version_id=vid)
        rng = request.headers.get("Range", "")
        part_q = request.rel_url.query.get("partNumber", "")

        def part_window(oi) -> tuple[int, int, int]:
            """(offset, length, parts_count) of ?partNumber=N (GET/HEAD part
            reads, the reference's opts.PartNumber path). Stored part sizes
            only equal logical bytes for untransformed objects; transformed
            and tiered payloads reject the parameter."""
            if rng:
                raise S3Error("InvalidArgument", "partNumber cannot combine with Range")
            try:
                pn = int(part_q)
            except ValueError:
                raise S3Error("InvalidArgument", "bad partNumber") from None
            if self._is_transformed(oi) or (
                self.tiering is not None and tiering_mod.is_transitioned(oi.internal)
            ):
                raise S3Error("NotImplemented", "partNumber on transformed object")
            parts = oi.parts or []
            if not parts:
                # Layers without stored part records (FS/NAS gateway
                # concatenate on complete): the object is one part.
                if pn != 1:
                    raise S3Error("InvalidPartNumber", resource=f"/{bucket}/{key}")
                return 0, oi.size, 1
            idx = next((i for i, p in enumerate(parts) if p.number == pn), None)
            if idx is None:
                raise S3Error("InvalidPartNumber", resource=f"/{bucket}/{key}")
            return sum(p.size for p in parts[:idx]), parts[idx].size, len(parts)

        try:
            if head:
                oi = self.layer.get_object_info(bucket, key, opts)
                cond = self._conditional_response(request, oi, bucket, key)
                if cond is not None:
                    return cond
                headers = self._object_headers(oi)
                headers.update(self._sse_response_headers(oi))
                if part_q:
                    p_off, p_len, n_parts = part_window(oi)
                    headers["Content-Length"] = str(p_len)
                    headers["x-amz-mp-parts-count"] = str(n_parts)
                    if p_len == 0:  # a 206 byte-range cannot describe 0 bytes
                        return web.Response(status=200, headers=headers)
                    headers["Content-Range"] = f"bytes {p_off}-{p_off + p_len - 1}/{oi.size}"
                    return web.Response(status=206, headers=headers)
                headers["Content-Length"] = str(self._logical_size(oi))
                return web.Response(status=200, headers=headers)
            offset, length = 0, -1
            if rng:
                offset, length, total_needed = _parse_range(rng)
            probe = self.layer.get_object_info(bucket, key, opts)
            if part_q:
                # Validate the part request BEFORE conditionals: a malformed
                # partNumber must 400/416, not 304 (mirrors Range, which is
                # parsed above).
                offset, length, n_parts = part_window(probe)
            cond = self._conditional_response(request, probe, bucket, key)
            if cond is not None:
                return cond  # before any data IO / tier recall / transform
            if part_q:
                if length > 0:  # empty part: plain 200, no byte-range
                    rng = f"part={part_q}"  # range semantics: 206 + Content-Range
            tiered = self.tiering is not None and tiering_mod.is_transitioned(probe.internal)
            if tiered or self._is_transformed(probe):
                # Tiered and/or transformed payloads: fetch whole (from the
                # remote tier for transitioned versions), undo transforms,
                # then apply the range on logical bytes.
                if tiered:
                    oi = probe
                    data = self.tiering.read_object(self.layer, bucket, key, probe)
                else:
                    oi, data = self.layer.get_object(bucket, key, opts)
                data = self._transform_get(bucket, key, data, oi, request)
                logical = len(data)
                if rng:
                    if offset < 0:  # suffix range: last N logical bytes
                        offset = max(logical + offset, 0)
                    if offset >= logical > 0:
                        raise S3Error("InvalidRange", resource=f"/{bucket}/{key}")
                    end = logical if length < 0 else min(offset + length, logical)
                    data = data[offset:end]
                oi.size = logical
            else:
                if rng and offset < 0:  # suffix range: last N bytes
                    offset = max(probe.size + offset, 0)
                    length = probe.size - offset
                stream_fn = getattr(self.layer, "get_object_stream", None)
                if stream_fn is not None:
                    if rng and offset >= probe.size and probe.size > 0:
                        raise S3Error("InvalidRange", resource=f"/{bucket}/{key}")
                    extra = {"x-amz-mp-parts-count": str(n_parts)} if part_q else None
                    return self._plan_stream(
                        stream_fn, bucket, key, opts, request, rng, offset, length,
                        extra_headers=extra,
                    )
                oi, data = self.layer.get_object(bucket, key, opts, offset=offset, length=length)
            if rng and offset >= oi.size and oi.size > 0:
                raise S3Error("InvalidRange", resource=f"/{bucket}/{key}")
            headers = self._object_headers(oi)
            headers.update(self._sse_response_headers(oi))
            status = 200
            if rng:
                total = self._logical_size(oi) if self._is_transformed(oi) else oi.size
                end = offset + len(data) - 1
                headers["Content-Range"] = f"bytes {offset}-{end}/{total}"
                status = 206
            return web.Response(status=status, body=data, headers=headers)
        except oerr.MethodNotAllowed:
            # GET on a delete marker by version id.
            return web.Response(status=405, headers={"x-amz-delete-marker": "true"})

    def _plan_stream(
        self, stream_fn, bucket, key, opts, request, rng, offset, length,
        extra_headers: dict | None = None,
    ) -> "web.Response | _StreamPlan":
        """Build the streaming GET plan: decoded blocks flow to the socket
        without materializing the object (the reference's writeDataBlocks ->
        ResponseWriter path, erasure-decode.go:206)."""
        # Last chance for a clean 503: once the plan is prepared the status
        # line and Content-Length are on the wire and a spent budget can
        # only abort the connection, not change the answer.
        try:
            deadline.check("streaming get")
        except oerr.DeadlineExceeded:
            GLOBAL_DEGRADE.record_deadline_abort("api-get")
            raise
        oi, it = stream_fn(bucket, key, opts, offset=offset, length=length)
        headers = self._object_headers(oi)
        headers.update(self._sse_response_headers(oi))
        if extra_headers:
            headers.update(extra_headers)
        end = oi.size if length < 0 else min(offset + length, oi.size)
        content_length = max(end - offset, 0)
        status = 200
        if rng:
            headers["Content-Range"] = f"bytes {offset}-{offset + content_length - 1}/{oi.size}"
            status = 206
        return _StreamPlan(status, headers, it, content_length)

    async def _send_stream(self, request: web.Request, plan: _StreamPlan) -> web.StreamResponse:
        resp = web.StreamResponse(status=plan.status, headers=plan.headers)
        # Streamed responses send headers at prepare(): the post-dispatch
        # header pass in _entry can't touch them, so CORS rides here.
        for hk, hv in self._cors_headers(request).items():
            resp.headers.setdefault(hk, hv)
        resp.content_length = plan.content_length
        await resp.prepare(request)
        it = plan.iterator
        # One span over the whole body stream: covers both pulling chunks
        # out of the (lazy) erasure read generator and pushing them onto
        # the socket -- the time a GET spends after headers.
        wr = tracing.span("response-write", "api", bytes=plan.content_length)
        sent = 0
        try:
            while True:
                chunk = await asyncio.to_thread(next, it, None)
                if chunk is None:
                    break
                sent += len(chunk)
                await resp.write(chunk)
        except Exception as e:
            # Headers (and a Content-Length promise) are already on the
            # wire: substituting an error response here would interleave
            # a second set of headers into the half-sent body and leave
            # the client waiting out the original length. Close the
            # connection instead so the client fails fast on truncation.
            wr.finish(error=type(e).__name__)
            # Copy-ledger hop: chunks handed to aiohttp by reference --
            # zero-copy from this layer's point of view (partial count on
            # an aborted stream is honest: those bytes did cross the hop).
            GLOBAL_PROFILER.copy.record("response-write", MOVED, sent)
            cur = tracing.current()
            if cur is not None:
                cur.set(stream_aborted=type(e).__name__)
            with contextlib.suppress(Exception):
                it.close()
            if request.transport is not None:
                request.transport.close()
        else:
            wr.finish()
            GLOBAL_PROFILER.copy.record("response-write", MOVED, sent)
            with contextlib.suppress(Exception):
                await resp.write_eof()
        return resp

    # -- object tagging / object lock ----------------------------------------

    TAGS_META = "x-internal-tags"

    def _put_object_lock_config(self, bucket: str, body: bytes) -> web.Response:
        """PUT ?object-lock: validated, and only on versioned buckets
        (lock implies versioning — AWS invariant)."""
        cfg = ol.LockConfig.from_xml(body.decode("utf-8", "replace"))
        if not cfg.enabled:
            raise S3Error("MalformedXML", "ObjectLockEnabled must be 'Enabled'")
        meta = self.bucket_meta.get(bucket)
        if not meta.versioning_enabled():
            raise S3Error(
                "InvalidBucketState",
                "object lock requires bucket versioning to be enabled",
            )
        self.bucket_meta.update(bucket, object_lock_xml=body.decode("utf-8", "replace"))
        self._site_meta_sync(bucket)
        return web.Response(status=200)

    @staticmethod
    def _vid(q) -> str:
        vid = q.get("versionId", "")
        return "" if vid == "null" else vid

    def _put_object_tagging(self, bucket: str, key: str, q, body: bytes) -> web.Response:
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        tags = []
        for el in root.iter():
            if el.tag.split("}")[-1] == "Tag":
                kv = {c.tag.split("}")[-1]: (c.text or "") for c in el}
                if "Key" not in kv:
                    raise S3Error("MalformedXML")
                tags.append((kv["Key"], kv.get("Value", "")))
        if len(tags) > 10:
            raise S3Error("InvalidArgument", "at most 10 tags per object")
        encoded = urllib.parse.urlencode(tags)
        self.layer.put_object_metadata(
            bucket, key, self._vid(q), updates={self.TAGS_META: encoded}
        )
        return web.Response(status=200)

    def _get_object_tagging(self, bucket: str, key: str, q) -> web.Response:
        oi = self.layer.get_object_info(bucket, key, GetObjectOptions(self._vid(q)))
        raw = oi.internal.get(self.TAGS_META, "")
        tags = urllib.parse.parse_qsl(raw, keep_blank_values=True)
        items = "".join(
            f"<Tag><Key>{escape(k)}</Key><Value>{escape(v)}</Value></Tag>" for k, v in tags
        )
        return _xml(
            f'<Tagging xmlns="{XML_NS}"><TagSet>{items}</TagSet></Tagging>'
        )

    def _delete_object_tagging(self, bucket: str, key: str, q) -> web.Response:
        self.layer.put_object_metadata(
            bucket, key, self._vid(q), removes=[self.TAGS_META]
        )
        return web.Response(status=204)

    def _require_lock_bucket(self, bucket: str):
        meta = self.bucket_meta.get(bucket)
        cfg = ol.LockConfig.from_xml(meta.object_lock_xml)
        if not cfg.enabled:
            raise S3Error(
                "InvalidRequest", "bucket is missing object lock configuration"
            )
        return cfg

    def _put_object_retention(
        self, bucket: str, key: str, q, body: bytes, request: web.Request
    ) -> web.Response:
        self._require_lock_bucket(bucket)
        mode, until = ol.parse_retention_xml(body)
        oi = self.layer.get_object_info(bucket, key, GetObjectOptions(self._vid(q)))
        old = ol.LockState.from_meta(oi.user_defined)
        bypass = request.headers.get("x-amz-bypass-governance-retention", "").lower() == "true"
        ak = request.get("access_key", "")
        may_bypass = bool(ak) and self.iam.is_allowed(
            ak, "s3:BypassGovernanceRetention", policy_mod.resource_arn(bucket, key),
            self._policy_context(request),
        )
        ol.check_retention_tighten(old, mode, until, bypass, may_bypass)
        self.layer.put_object_metadata(
            bucket, key, self._vid(q),
            updates={ol.META_MODE: mode, ol.META_RETAIN_UNTIL: until},
        )
        return web.Response(status=200)

    def _get_object_attributes(
        self, bucket: str, key: str, request: web.Request
    ) -> web.Response:
        """GetObjectAttributes (cmd/object-handlers.go
        GetObjectAttributesHandler): metadata-only view selected by the
        x-amz-object-attributes header — SDK sync paths use it for etag,
        logical size, and multipart layout without fetching the body.
        (ETag is UNQUOTED in this API, unlike every other response.)"""
        opts = GetObjectOptions(self._vid(request.rel_url.query))
        oi = self.layer.get_object_info(bucket, key, opts)
        if oi.delete_marker:
            raise S3Error("MethodNotAllowed", resource=f"/{bucket}/{key}")
        wanted = {
            a.strip()
            for a in request.headers.get("x-amz-object-attributes", "").split(",")
            if a.strip()
        }
        if not wanted:
            raise S3Error("InvalidRequest", "x-amz-object-attributes header required")
        parts_xml = ""
        # ObjectParts only for MULTIPART objects (composite "-N" etag):
        # plain PUTs also record one internal part, but S3 omits the
        # section for them — and a 1-part multipart must still include it.
        is_multipart = bool(re.fullmatch(r"[0-9a-f]{32}-\d+", oi.etag))
        if "ObjectParts" in wanted and is_multipart and oi.parts:
            parts_xml = (
                f"<ObjectParts><TotalPartsCount>{len(oi.parts)}</TotalPartsCount>"
                + "".join(
                    # Logical per-part sizes (actual_size >= 0 when the
                    # stored form is transformed), consistent with
                    # ObjectSize below.
                    f"<Part><PartNumber>{p.number}</PartNumber>"
                    f"<Size>{p.actual_size if p.actual_size >= 0 else p.size}</Size></Part>"
                    for p in oi.parts
                )
                + "</ObjectParts>"
            )
        body = (
            f'<GetObjectAttributesResponse xmlns="{XML_NS}">'
            + (f"<ETag>{escape(oi.etag)}</ETag>" if "ETag" in wanted else "")
            + parts_xml
            + (
                f"<StorageClass>{escape(oi.storage_class)}</StorageClass>"
                if "StorageClass" in wanted
                else ""
            )
            + (
                f"<ObjectSize>{_display_size(oi)}</ObjectSize>"
                if "ObjectSize" in wanted
                else ""
            )
            + "</GetObjectAttributesResponse>"
        )
        headers = {"Last-Modified": _http_date(oi.mod_time)}
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        resp = _xml(body)
        resp.headers.update(headers)
        return resp

    def _get_object_retention(self, bucket: str, key: str, q) -> web.Response:
        self._require_lock_bucket(bucket)
        oi = self.layer.get_object_info(bucket, key, GetObjectOptions(self._vid(q)))
        st = ol.LockState.from_meta(oi.user_defined)
        if not st.mode:
            raise S3Error("NoSuchObjectLockConfiguration")
        return _xml(ol.retention_xml(st.mode, st.retain_until))

    def _put_object_legal_hold(self, bucket: str, key: str, q, body: bytes) -> web.Response:
        self._require_lock_bucket(bucket)
        status = ol.parse_legal_hold_xml(body)
        self.layer.put_object_metadata(
            bucket, key, self._vid(q), updates={ol.META_LEGAL_HOLD: status}
        )
        return web.Response(status=200)

    def _get_object_legal_hold(self, bucket: str, key: str, q) -> web.Response:
        self._require_lock_bucket(bucket)
        oi = self.layer.get_object_info(bucket, key, GetObjectOptions(self._vid(q)))
        st = ol.LockState.from_meta(oi.user_defined)
        return _xml(ol.legal_hold_xml(st.legal_hold or "OFF"))

    def _select_object(
        self, bucket: str, key: str, body: bytes, request: web.Request
    ) -> web.Response:
        """SelectObjectContent — SQL over an object, event-stream response.

        Reference: object-handlers.go SelectObjectContentHandler +
        internal/s3select (re-designed in minio_tpu_torch/s3select/).
        """
        from ..s3select import S3SelectRequest, run_select
        from ..s3select.select import SelectError

        def select_err(e: SelectError) -> web.Response:
            return _xml(
                f"<Error><Code>{escape(e.code)}</Code>"
                f"<Message>{escape(e.message)}</Message>"
                f"<Resource>/{escape(bucket)}/{escape(key)}</Resource>"
                "</Error>",
                e.status,
            )

        try:
            sreq = S3SelectRequest.from_xml(body)
        except SelectError as e:
            return select_err(e)

        def get_data(_off, _ln) -> bytes:
            return self._read_logical(bucket, key, request)[1]

        # No separate existence probe: the response is fully buffered below,
        # so a NoSuchKey raised by the first get_data still surfaces as a
        # plain S3 error via the dispatcher (no event stream has started) —
        # and _read_logical already probes once per read.
        try:
            frames = list(run_select(sreq, get_data))
        except SelectError as e:
            return select_err(e)
        return web.Response(
            status=200,
            body=b"".join(frames),
            headers={"Content-Type": "application/octet-stream"},
        )

    def _restore_object(self, bucket: str, key: str, q, body: bytes) -> web.Response:
        """POST ?restore: materialize a transitioned object locally for N days
        (PostRestoreObjectHandler, cmd/bucket-lifecycle.go role)."""
        if self.tiering is None:
            raise S3Error("NotImplemented")
        days = 1
        if body:
            try:
                root = ET.fromstring(body)
                for c in root.iter():
                    if c.tag.split("}")[-1] == "Days" and c.text:
                        days = int(c.text)
            except ET.ParseError:
                raise S3Error("MalformedXML")
        vid = self._vid(q)
        try:
            oi = self.layer.get_object_info(bucket, key, GetObjectOptions(vid))
        except oerr.StorageError as e:
            raise from_object_error(e, bucket, key)
        already = tiering_mod.restore_expiry(oi.user_defined) > _time.time()
        self.tiering.restore(self.layer, bucket, key, vid, days)
        # 200 if refreshing an existing restore, 202 for a new one (S3 wire).
        return web.Response(status=200 if already else 202)

    def _delete_object(self, bucket: str, key: str, q, request=None) -> web.Response:
        vid = self._vid(q)
        meta = self.bucket_meta.get(bucket)
        if vid and meta.object_lock_xml:
            # WORM: deleting a specific version checks retention/legal hold.
            try:
                oi = self.layer.get_object_info(bucket, key, GetObjectOptions(vid))
            except (oerr.ObjectNotFound, oerr.VersionNotFound, oerr.MethodNotAllowed):
                oi = None
            if oi is not None:
                bypass = bool(
                    request is not None
                    and request.headers.get("x-amz-bypass-governance-retention", "").lower()
                    == "true"
                )
                may_bypass = False
                if request is not None and bypass:
                    ak = request.get("access_key", "")
                    may_bypass = bool(ak) and self.iam.is_allowed(
                        ak, "s3:BypassGovernanceRetention",
                        policy_mod.resource_arn(bucket, key),
                        self._policy_context(request),
                    )
                ol.check_delete_allowed(oi.user_defined, bypass, may_bypass)
        # Permanent deletes of transitioned versions journal the remote tier
        # copy for async reclamation (tier-journal.go role) — but only AFTER
        # the local delete succeeds, or a failed delete would orphan a live
        # version whose tier bytes get reclaimed underneath it.
        tier_meta = None
        if self.tiering is not None and (vid or not meta.versioning_enabled()):
            try:
                probe = self.layer.get_object_info(bucket, key, GetObjectOptions(vid))
                if tiering_mod.is_transitioned(probe.internal):
                    tier_meta = probe.internal
            except oerr.StorageError:
                pass
        opts = DeleteObjectOptions(version_id=vid, versioned=meta.versioning_enabled())
        oi = self.layer.delete_object(bucket, key, opts)
        if tier_meta is not None:
            self.tiering.journal_delete(tier_meta)
        headers = {}
        if oi.delete_marker:
            headers["x-amz-delete-marker"] = "true"
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        # Deletes arriving FROM a source cluster's replication worker must not
        # re-replicate — active-active (bidirectional) targets would ping-pong
        # delete markers forever otherwise. Same permission gate as replica
        # PUTs so the header can't be abused to dodge replication.
        from ..control import replication as repl_mod

        is_replica_op = bool(
            request is not None
            and request.headers.get(repl_mod.HDR_SOURCE_REPL, "") == "true"
            and self.iam.is_allowed(
                request.get("access_key", ""),
                "s3:ReplicateObject",
                policy_mod.resource_arn(bucket, key),
                self._policy_context(request),
            )
        )
        self._emit("s3:ObjectRemoved:Delete", bucket, oi, replicate=not is_replica_op)
        return web.Response(status=204, headers=headers)

    def _emit(
        self, event_name: str, bucket: str, oi: ObjectInfo, replicate: bool = True
    ) -> None:
        if self.replication is not None and replicate:
            try:
                if event_name.startswith("s3:ObjectCreated:"):
                    self.replication.on_put(bucket, oi)
                elif event_name.startswith("s3:ObjectRemoved:"):
                    self.replication.on_delete(bucket, oi)
            except Exception as e:  # noqa: BLE001 - replication is async best-effort
                GLOBAL_LOGGER.error(
                    f"replication hook failed: {event_name} {bucket}/{oi.name}", exc=e
                )
        if self.notifier is not None:
            from ..control.events import Event

            try:
                self.notifier.emit(
                    Event(
                        name=event_name,
                        bucket=bucket,
                        object_name=oi.name,
                        etag=oi.etag,
                        # Event consumers see S3 semantics: the object's
                        # logical size, not the stored transformed form.
                        size=_display_size(oi),
                        version_id=oi.version_id,
                        region=self.region,
                    )
                )
            except Exception as e:  # noqa: BLE001 - notification must not fail the op
                GLOBAL_LOGGER.error(
                    f"event notification failed: {event_name} {bucket}/{oi.name}", exc=e
                )
        if self.on_event is not None:
            try:
                self.on_event(event_name, bucket, oi)
            except Exception as e:  # noqa: BLE001 - observer hook must not fail the op
                GLOBAL_LOGGER.error(f"on_event hook failed: {event_name}", exc=e)


def _api_name(method: str, bucket: str, key: str, q) -> str:
    if not bucket:
        return "ListBuckets" if method == "GET" else "STS"
    if key:
        base = {"GET": "GetObject", "HEAD": "HeadObject", "PUT": "PutObject",
                "DELETE": "DeleteObject", "POST": "PostObject"}.get(method, method)
        if "uploadId" in q or "uploads" in q:
            return "Multipart" + base
        return base
    names = {"GET": "ListObjects", "HEAD": "HeadBucket", "PUT": "PutBucket",
             "DELETE": "DeleteBucket", "POST": "DeleteMultipleObjects"}
    return names.get(method, method)


def _parse_range(rng: str) -> tuple[int, int, bool]:
    """Parse 'bytes=a-b' into (offset, length)."""
    if not rng.startswith("bytes="):
        raise S3Error("InvalidArgument", "bad range")
    spec = rng[len("bytes=") :]
    if "," in spec:
        raise S3Error("NotImplemented", "multiple ranges")
    start_s, _, end_s = spec.partition("-")
    if start_s == "":
        # Suffix range 'bytes=-N' (last N bytes): returned as a NEGATIVE
        # offset; callers resolve it against the object size.
        try:
            n = int(end_s)
        except ValueError:
            raise S3Error("InvalidArgument", "bad range") from None
        if n <= 0:
            raise S3Error("InvalidArgument", "bad range")
        return -n, n, True
    start = int(start_s)
    if end_s == "":
        return start, -1, True
    end = int(end_s)
    if end < start:
        raise S3Error("InvalidArgument", "bad range")
    return start, end - start + 1, True


# -- serving ------------------------------------------------------------------


def run_server(server: S3Server, host: str = "127.0.0.1", port: int = 9000) -> None:
    web.run_app(server.app, host=host, port=port, print=None)


class ThreadedServer:
    """Run the API server on a background thread (tests + embedded use).

    The analogue of the reference's httptest-based TestServer
    (cmd/test-utils_test.go:290)."""

    def __init__(self, server: S3Server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self.host = host
        self.port = port
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread = None
        self._started = None

    def start(self) -> str:
        import threading

        self._started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)

            async def setup():
                runner = web.AppRunner(self.server.app)
                await runner.setup()
                site = web.TCPSite(runner, self.host, self.port)
                await site.start()
                self.port = runner.addresses[0][1]
                self._runner = runner
                self._started.set()

            loop.run_until_complete(setup())
            loop.run_forever()

        self._thread = __import__("threading").Thread(target=run, daemon=True)
        self._thread.start()
        self._started.wait(10)
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._loop is not None:
            loop = self._loop

            async def teardown():
                await self._runner.cleanup()
                # The loop's default executor ran the handlers' blocking
                # calls: its threads end with the server.
                await loop.shutdown_default_executor(timeout=5)
                loop.stop()

            asyncio.run_coroutine_threadsafe(teardown(), loop)
            self._thread.join(10)
