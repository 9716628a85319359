"""The S3 HTTP front of minio_tpu_torch on the CPU, held against the JAX
package's front over real sockets.

Both packages get the same deployment (one pool of 2 sets x 4 drives on the
same format.json) behind their own S3Server on a ThreadedServer, with the
same root credentials, the same static KMS master key and an event
notifier each (ListenNotification streams are compared). The port runs
its BatchingDeviceCodec on device="cpu" (the kernels' plain torch
versions), the JAX package its HostCodec. One scripted list of signed
requests, with bodies made from a numpy seed, goes to both servers, each
step to the JAX server and then to the port's.

Tolerance: exact. Every status, the listed headers and every object body
must be equal; XML bodies are parsed and compared element by element, with
the fields that are random in each server (request ids, version ids,
upload ids, timestamps) compared by position and shape, never by value.
Then every object's part files, inline data and the erasure fields of its
xl.meta must be equal across the two drive trees. The stated exception:
the SSE objects, whose ciphertext is random in each package
(their plaintext, etag and logical size are compared, their stored bytes
and digests are not).

The port hashes on the CPU with its per-packet torch loop (~3 s per
100 KiB row), so the objects are as small as their size class allows, the
1 MiB-plus-tail object is only ever read by its tail, and the ranges read
inline objects.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import http.client
import io
import json
import os
import re
import urllib.parse
import xml.etree.ElementTree as ET
import zipfile
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu_torch
from minio_tpu.api.server import S3Server as JaxS3Server
from minio_tpu.api.server import ThreadedServer as JaxThreadedServer
from minio_tpu.control.events import EventNotifier as JaxEventNotifier
from minio_tpu.control.iam import IAMSys as JaxIAMSys
from minio_tpu.control.kms import StaticKeyKMS as JaxStaticKeyKMS
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.api import auth, postpolicy, sigv2, streaming
from minio_tpu_torch.api.server import S3Server, ThreadedServer
from minio_tpu_torch.control.events import EventNotifier
from minio_tpu_torch.control.iam import IAMSys
from minio_tpu_torch.control.kms import StaticKeyKMS
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

SETS, SET_DRIVES = 2, 4
RRS_PARITY = 1
ROOT = ("rootak", "root-secret-key")
KMS_MASTER = bytes(range(32))
SSEC_KEY = bytes(range(100, 132))
MiB = 1 << 20

# Headers compared by value on every response.
HEADERS = (
    "ETag", "Content-Length", "Content-Range", "Content-Type", "x-amz-delete-marker",
    "x-amz-mp-parts-count", "x-amz-tagging-count",
)
# XML elements whose values are random in each server: compared by shape.
RANDOM_XML = {
    "LastModified", "Initiated", "CreationDate", "VersionId", "UploadId", "RequestId",
    "NextUploadIdMarker", "NextVersionIdMarker",
    # STS credentials: "STS" + hex, the session token naming it, the expiry
    "AccessKeyId", "SessionToken", "Expiration",
}

rng = np.random.default_rng(20261017)


def _bytes(n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


BODIES = {
    "tiny": _bytes(37),
    "inline": _bytes(20 << 10),
    "short": _bytes(136 << 10),
    "multi": _bytes(MiB + 37),
    "rrs": _bytes(200 << 10),
    "chunked": _bytes(140 << 10),
    "md5-inline": _bytes(5 << 10),
    "md5-stream": _bytes(130 << 10),
    "part1": _bytes(40 << 10),
    "small-part": _bytes(10 << 10),
    "sse": _bytes(20 << 10),
    "pub": _bytes(3 << 10),
    "post": _bytes(6 << 10),
    "deadline": _bytes(200 << 10),
    "ver1": _bytes(1000),
    "ver2": _bytes(2000),
    "lock": _bytes(4000),
}


def _zip_body() -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name, n in (("dir/a.txt", 700), ("dir/b.bin", 900), ("top.txt", 50)):
            info = zipfile.ZipInfo(name, date_time=(2024, 1, 2, 3, 4, 6))
            info.compress_type = zipfile.ZIP_DEFLATED
            z.writestr(info, rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    return buf.getvalue()


BODIES["zip"] = _zip_body()


@dataclass
class Resp:
    status: int
    headers: dict
    body: bytes


@dataclass
class Client:
    """One server's signing HTTP client and the per-server values (upload
    ids, version ids, continuation tokens) later steps reuse."""

    name: str
    endpoint: str
    state: dict = field(default_factory=dict)

    @property
    def host(self) -> str:
        return urllib.parse.urlparse(self.endpoint).netloc

    def send(
        self, method: str, path: str, query=(), body: bytes = b"", headers=None,
        sign: str = "v4", timestamp=None, payload_hash=None, url: str | None = None,
    ) -> Resp:
        query = list(query)
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        if sign == "v4":
            headers["host"] = self.host
            headers = auth.sign_request(
                auth.Credentials(*ROOT), method, path, query, headers,
                None if payload_hash else body, timestamp=timestamp, payload_hash=payload_hash,
            )
            headers.pop("host")
        elif sign == "v2":
            headers = sigv2.sign_request_v2(*ROOT, method, path, query, headers)
        if url is None:
            url = urllib.parse.quote(path)
            if query:
                url += "?" + urllib.parse.urlencode(query)
        conn = http.client.HTTPConnection(self.host, timeout=300)
        try:
            conn.request(method, url, body=body, headers=headers)
            r = conn.getresponse()
            return Resp(r.status, {k.lower(): v for k, v in r.getheaders()}, r.read())
        finally:
            conn.close()


STEPS: list[tuple[str, object]] = []


def step(name: str):
    def deco(fn):
        STEPS.append((name, fn))
        return fn
    return deco


def _put(c: Client, key: str, body: bytes, headers=None, bucket="bkt") -> Resp:
    return c.send("PUT", f"/{bucket}/{key}", body=body, headers=headers)


def _get(c: Client, key: str, headers=None, query=(), bucket="bkt") -> Resp:
    return c.send("GET", f"/{bucket}/{key}", query=query, headers=headers)


def _ssec_headers(prefix: str = "") -> dict:
    return {
        f"x-amz-{prefix}server-side-encryption-customer-algorithm": "AES256",
        f"x-amz-{prefix}server-side-encryption-customer-key": base64.b64encode(SSEC_KEY).decode(),
        f"x-amz-{prefix}server-side-encryption-customer-key-md5": base64.b64encode(
            hashlib.md5(SSEC_KEY).digest()
        ).decode(),
    }


def _delete_xml(keys, quiet=False) -> bytes:
    objs = "".join(f"<Object><Key>{k}</Key></Object>" for k in keys)
    return f"<Delete><Quiet>{'true' if quiet else 'false'}</Quiet>{objs}</Delete>".encode()


# -- the script ---------------------------------------------------------------------

# buckets
step("make-bucket")(lambda c: c.send("PUT", "/bkt"))
step("make-bucket-again")(lambda c: c.send("PUT", "/bkt"))
step("make-bucket-bad-name")(lambda c: c.send("PUT", "/ab"))
step("head-bucket")(lambda c: c.send("HEAD", "/bkt"))
step("head-missing-bucket")(lambda c: c.send("HEAD", "/nobkt"))
step("bucket-location")(lambda c: c.send("GET", "/bkt", query=[("location", "")]))
step("bucket-versioning-unset")(lambda c: c.send("GET", "/bkt", query=[("versioning", "")]))
step("bucket-tagging-missing")(lambda c: c.send("GET", "/bkt", query=[("tagging", "")]))
step("bucket-acl")(lambda c: c.send("GET", "/bkt", query=[("acl", "")]))
step("cors-preflight")(lambda c: c.send(
    "OPTIONS", "/bkt/x", sign="none",
    headers={"Origin": "http://example.com", "Access-Control-Request-Method": "PUT"},
))

# every size class, plain PUT
step("put-tiny")(lambda c: _put(c, "size/tiny", BODIES["tiny"], {"x-amz-meta-color": "blue"}))
step("put-inline")(lambda c: _put(c, "size/inline", BODIES["inline"], {"Content-Type": "text/plain"}))
step("put-short-block")(lambda c: _put(c, "size/short", BODIES["short"]))
step("put-block-plus-tail")(lambda c: _put(c, "size/multi", BODIES["multi"]))
step("put-rrs")(lambda c: _put(c, "size/rrs", BODIES["rrs"], {"x-amz-storage-class": "REDUCED_REDUNDANCY"}))
step("put-bad-storage-class")(lambda c: _put(c, "size/bad", b"x", {"x-amz-storage-class": "GLACIER"}))


@step("put-aws-chunked")
def _chunked(c: Client) -> Resp:
    payload = BODIES["chunked"]
    headers = {
        "host": c.host, "content-encoding": "aws-chunked",
        "x-amz-decoded-content-length": str(len(payload)),
    }
    headers = auth.sign_request(
        auth.Credentials(*ROOT), "PUT", "/bkt/size/chunked", [], headers, None,
        payload_hash=auth.STREAMING_PAYLOAD,
    )
    seed = headers["authorization"].rsplit("Signature=", 1)[1]
    body = streaming.encode_chunked(
        payload, seed, auth.Credentials(*ROOT), headers["x-amz-date"], "us-east-1", chunk_size=64 << 10
    )
    headers.pop("host")
    return c.send("PUT", "/bkt/size/chunked", body=body, headers=headers, sign="none")


def _md5_b64(b: bytes) -> str:
    return base64.b64encode(hashlib.md5(b).digest()).decode()


step("put-content-md5-inline")(lambda c: _put(
    c, "md5/inline", BODIES["md5-inline"], {"Content-MD5": _md5_b64(BODIES["md5-inline"])}))
step("put-content-md5-streaming")(lambda c: _put(
    c, "md5/stream", BODIES["md5-stream"], {"Content-MD5": _md5_b64(BODIES["md5-stream"])}))
step("put-content-md5-bad")(lambda c: _put(
    c, "md5/bad", BODIES["md5-inline"], {"Content-MD5": _md5_b64(b"other")}))
step("put-sha256-mismatch")(lambda c: c.send(
    "PUT", "/bkt/md5/sha-bad", body=BODIES["tiny"], payload_hash="0" * 64))

# reads
for _k in ("tiny", "inline", "short", "rrs", "chunked"):
    step(f"get-{_k}")(lambda c, k=_k: _get(c, f"size/{k}"))
step("get-md5-stream")(lambda c: _get(c, "md5/stream"))
step("get-md5-bad-absent")(lambda c: _get(c, "md5/bad"))
for _k in ("tiny", "inline", "short", "multi", "rrs", "chunked"):
    step(f"head-{_k}")(lambda c, k=_k: c.send("HEAD", f"/bkt/size/{k}"))
step("head-missing")(lambda c: c.send("HEAD", "/bkt/size/none"))
step("get-missing")(lambda c: _get(c, "size/none"))
step("range-first-byte")(lambda c: _get(c, "size/inline", {"Range": "bytes=0-0"}))
step("range-window")(lambda c: _get(c, "size/inline", {"Range": "bytes=100-1099"}))
step("range-open-end")(lambda c: _get(c, "size/inline", {"Range": "bytes=20000-"}))
step("range-suffix")(lambda c: _get(c, "size/inline", {"Range": "bytes=-100"}))
step("range-suffix-tail-block")(lambda c: _get(c, "size/multi", {"Range": "bytes=-30"}))
step("range-past-end")(lambda c: _get(c, "size/inline", {"Range": "bytes=999999-"}))


@step("if-none-match-304")
def _inm(c: Client) -> Resp:
    etag = c.send("HEAD", "/bkt/size/inline").headers["etag"]
    return _get(c, "size/inline", {"If-None-Match": etag})


step("if-match-412")(lambda c: _get(c, "size/inline", {"If-Match": '"0123"'}))
step("if-none-match-other-200")(lambda c: _get(c, "size/tiny", {"If-None-Match": '"0123"'}))
step("if-modified-since-304")(lambda c: c.send(
    "HEAD", "/bkt/size/tiny", headers={"If-Modified-Since": "Fri, 01 Jan 2100 00:00:00 GMT"}))
step("if-unmodified-since-412")(lambda c: c.send(
    "HEAD", "/bkt/size/tiny", headers={"If-Unmodified-Since": "Mon, 01 Jan 2001 00:00:00 GMT"}))
step("object-attributes")(lambda c: c.send(
    "GET", "/bkt/size/short", query=[("attributes", "")],
    headers={"x-amz-object-attributes": "ETag,ObjectSize,StorageClass,ObjectParts"}))

# listings
step("list-v1")(lambda c: c.send("GET", "/bkt"))
step("list-v1-prefix-delimiter")(lambda c: c.send(
    "GET", "/bkt", query=[("prefix", "size/"), ("delimiter", "/")]))
step("list-v1-delimiter")(lambda c: c.send("GET", "/bkt", query=[("delimiter", "/")]))
step("list-v1-marker-max-keys")(lambda c: c.send(
    "GET", "/bkt", query=[("marker", "size/inline"), ("max-keys", "2"), ("delimiter", "/"), ("prefix", "size/")]))
step("list-v2-url-encoded")(lambda c: c.send(
    "GET", "/bkt", query=[("list-type", "2"), ("encoding-type", "url")]))


@step("list-v2-page-1")
def _v2p1(c: Client) -> Resp:
    r = c.send("GET", "/bkt", query=[("list-type", "2"), ("max-keys", "3")])
    c.state["token"] = ET.fromstring(r.body).findtext("{*}NextContinuationToken")
    return r


step("list-v2-page-2")(lambda c: c.send(
    "GET", "/bkt", query=[("list-type", "2"), ("max-keys", "3"), ("continuation-token", c.state["token"])]))
step("list-v2-start-after")(lambda c: c.send(
    "GET", "/bkt", query=[("list-type", "2"), ("start-after", "size/multi")]))

# versioned bucket
step("make-versioned-bucket")(lambda c: c.send("PUT", "/vbkt"))
step("enable-versioning")(lambda c: c.send(
    "PUT", "/vbkt", query=[("versioning", "")],
    body=b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"))
step("get-versioning")(lambda c: c.send("GET", "/vbkt", query=[("versioning", "")]))


@step("put-version-1")
def _v1(c: Client) -> Resp:
    r = _put(c, "v/obj", BODIES["ver1"], bucket="vbkt")
    c.state["v1"] = r.headers.get("x-amz-version-id", "")
    return r


step("put-version-2")(lambda c: _put(c, "v/obj", BODIES["ver2"], bucket="vbkt"))
step("put-other-version")(lambda c: _put(c, "v/other", BODIES["tiny"], bucket="vbkt"))
step("delete-marker")(lambda c: c.send("DELETE", "/vbkt/v/obj"))
step("get-latest-is-marker")(lambda c: _get(c, "v/obj", bucket="vbkt"))
step("get-version-1")(lambda c: _get(c, "v/obj", query=[("versionId", c.state["v1"])], bucket="vbkt"))
step("list-versions")(lambda c: c.send("GET", "/vbkt", query=[("versions", "")]))
step("list-versions-prefix-delimiter")(lambda c: c.send(
    "GET", "/vbkt", query=[("versions", ""), ("prefix", "v/"), ("delimiter", "/"), ("max-keys", "2")]))
step("delete-version-1")(lambda c: c.send("DELETE", "/vbkt/v/obj", query=[("versionId", c.state["v1"])]))
step("list-versions-after")(lambda c: c.send("GET", "/vbkt", query=[("versions", "")]))

# copy, tagging, deletes
step("copy-object")(lambda c: c.send("PUT", "/bkt/copy/inline", headers={"x-amz-copy-source": "/bkt/size/inline"}))
step("copy-object-replace")(lambda c: c.send("PUT", "/bkt/copy/tiny", headers={
    "x-amz-copy-source": "/bkt/size/tiny", "x-amz-metadata-directive": "REPLACE",
    "x-amz-meta-color": "red", "Content-Type": "text/csv"}))
step("copy-precondition-412")(lambda c: c.send("PUT", "/bkt/copy/none", headers={
    "x-amz-copy-source": "/bkt/size/tiny", "x-amz-copy-source-if-match": '"0123"'}))
step("get-copy")(lambda c: _get(c, "copy/inline"))
step("head-copy-replace")(lambda c: c.send("HEAD", "/bkt/copy/tiny"))
step("put-with-tagging-header")(lambda c: _put(c, "tags/a", BODIES["tiny"], {"x-amz-tagging": "k1=v1&k2=v2"}))
step("put-object-tagging")(lambda c: c.send(
    "PUT", "/bkt/size/tiny", query=[("tagging", "")],
    body=b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
    b"<Tag><Key>team</Key><Value>s3</Value></Tag></TagSet></Tagging>"))
step("get-object-tagging")(lambda c: c.send("GET", "/bkt/size/tiny", query=[("tagging", "")]))
step("head-tagging-count")(lambda c: c.send("HEAD", "/bkt/size/tiny"))
step("delete-object-tagging")(lambda c: c.send("DELETE", "/bkt/size/tiny", query=[("tagging", "")]))
step("head-tagging-count-after")(lambda c: c.send("HEAD", "/bkt/tags/a"))
step("delete-object")(lambda c: c.send("DELETE", "/bkt/copy/tiny"))
step("delete-missing-object")(lambda c: c.send("DELETE", "/bkt/copy/never"))
step("delete-objects")(lambda c: c.send(
    "POST", "/bkt", query=[("delete", "")], body=_delete_xml(["tags/a", "copy/inline", "nope/x"])))
step("delete-objects-quiet")(lambda c: c.send(
    "POST", "/bkt", query=[("delete", "")], body=_delete_xml(["md5/inline"], quiet=True)))
step("delete-objects-malformed")(lambda c: c.send("POST", "/bkt", query=[("delete", "")], body=b"<Delete"))

# multipart
@step("initiate-multipart")
def _init_mp(c: Client) -> Resp:
    r = c.send("POST", "/bkt/mp/obj", query=[("uploads", "")], headers={"Content-Type": "application/x-bin"})
    c.state["upload"] = ET.fromstring(r.body).findtext("{*}UploadId")
    return r


@step("upload-part")
def _part(c: Client) -> Resp:
    r = c.send("PUT", "/bkt/mp/obj", query=[("partNumber", "1"), ("uploadId", c.state["upload"])],
               body=BODIES["part1"])
    c.state["part-etag"] = r.headers.get("etag", "")
    return r


step("list-parts")(lambda c: c.send("GET", "/bkt/mp/obj", query=[("uploadId", c.state["upload"])]))


@step("initiate-second-upload")
def _init_mp2(c: Client) -> Resp:
    r = c.send("POST", "/bkt/mp/aborted", query=[("uploads", "")])
    c.state["upload2"] = ET.fromstring(r.body).findtext("{*}UploadId")
    return r


@step("upload-small-parts")
def _small_parts(c: Client) -> Resp:
    etags = []
    for n in (1, 2):
        r = c.send("PUT", "/bkt/mp/aborted", query=[("partNumber", str(n)), ("uploadId", c.state["upload2"])],
                   body=BODIES["small-part"])
        etags.append(r.headers["etag"])
    c.state["small-etags"] = etags
    return r


step("list-multipart-uploads")(lambda c: c.send("GET", "/bkt", query=[("uploads", "")]))


def _complete_xml(parts) -> bytes:
    inner = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>" for n, e in parts)
    return f"<CompleteMultipartUpload>{inner}</CompleteMultipartUpload>".encode()


step("complete-too-small-part")(lambda c: c.send(
    "POST", "/bkt/mp/aborted", query=[("uploadId", c.state["upload2"])],
    body=_complete_xml(list(zip((1, 2), c.state["small-etags"])))))
step("abort-upload")(lambda c: c.send("DELETE", "/bkt/mp/aborted", query=[("uploadId", c.state["upload2"])]))
step("list-parts-aborted")(lambda c: c.send("GET", "/bkt/mp/aborted", query=[("uploadId", c.state["upload2"])]))
step("complete-multipart")(lambda c: c.send(
    "POST", "/bkt/mp/obj", query=[("uploadId", c.state["upload"])],
    body=_complete_xml([(1, c.state["part-etag"])])))
step("list-multipart-uploads-after")(lambda c: c.send("GET", "/bkt", query=[("uploads", "")]))
step("get-multipart-object")(lambda c: _get(c, "mp/obj"))
step("head-part-number")(lambda c: c.send("HEAD", "/bkt/mp/obj", query=[("partNumber", "1")]))

# object lock
step("make-lock-bucket")(lambda c: c.send("PUT", "/lbkt", headers={"x-amz-bucket-object-lock-enabled": "true"}))
step("get-lock-config")(lambda c: c.send("GET", "/lbkt", query=[("object-lock", "")]))


@step("put-locked-object")
def _locked(c: Client) -> Resp:
    r = _put(c, "l/obj", BODIES["lock"], bucket="lbkt", headers={
        "x-amz-object-lock-mode": "GOVERNANCE",
        "x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00Z",
    })
    c.state["lock-vid"] = r.headers.get("x-amz-version-id", "")
    return r


step("lock-headers-on-plain-bucket")(lambda c: _put(c, "l/no", b"x", {
    "x-amz-object-lock-mode": "GOVERNANCE", "x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00Z"}))
step("get-retention")(lambda c: c.send("GET", "/lbkt/l/obj", query=[("retention", "")]))
step("put-legal-hold")(lambda c: c.send(
    "PUT", "/lbkt/l/obj", query=[("legal-hold", "")],
    body=b"<LegalHold><Status>ON</Status></LegalHold>"))
step("get-legal-hold")(lambda c: c.send("GET", "/lbkt/l/obj", query=[("legal-hold", "")]))
step("shorten-retention-refused")(lambda c: c.send(
    "PUT", "/lbkt/l/obj", query=[("retention", "")],
    body=b"<Retention><Mode>COMPLIANCE</Mode><RetainUntilDate>2030-01-01T00:00:00Z</RetainUntilDate></Retention>"))
step("delete-locked-version-refused")(lambda c: c.send(
    "DELETE", "/lbkt/l/obj", query=[("versionId", c.state["lock-vid"])]))
step("suspend-versioning-refused")(lambda c: c.send(
    "PUT", "/lbkt", query=[("versioning", "")],
    body=b"<VersioningConfiguration><Status>Suspended</Status></VersioningConfiguration>"))
step("head-locked-object")(lambda c: c.send("HEAD", "/lbkt/l/obj"))

# bucket policy and anonymous access
PUBLIC_POLICY = json.dumps({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Principal": {"AWS": ["*"]}, "Action": ["s3:GetObject"],
                   "Resource": ["arn:aws:s3:::pbkt/*"]}],
}).encode()
step("make-public-bucket")(lambda c: c.send("PUT", "/pbkt"))
step("put-public-object")(lambda c: _put(c, "pub/obj", BODIES["pub"], bucket="pbkt"))
step("anonymous-get-before-policy")(lambda c: c.send("GET", "/pbkt/pub/obj", sign="none"))
step("put-bucket-policy")(lambda c: c.send("PUT", "/pbkt", query=[("policy", "")], body=PUBLIC_POLICY))
step("get-bucket-policy")(lambda c: c.send("GET", "/pbkt", query=[("policy", "")]))
step("policy-status")(lambda c: c.send("GET", "/pbkt", query=[("policyStatus", "")]))
step("anonymous-get")(lambda c: c.send("GET", "/pbkt/pub/obj", sign="none"))
step("anonymous-list-refused")(lambda c: c.send("GET", "/pbkt", sign="none"))
step("anonymous-get-other-bucket")(lambda c: c.send("GET", "/bkt/size/tiny", sign="none"))
step("bad-policy-refused")(lambda c: c.send("PUT", "/pbkt", query=[("policy", "")], body=b"{not json"))

# other signatures
step("presigned-v4-get")(lambda c: c.send("GET", "/bkt/size/inline", sign="none", url=_path_of(
    auth.SigV4Verifier(lambda ak: None).presign_url(
        auth.Credentials(*ROOT), "GET", "/bkt/size/inline", [], c.host, expires=600))))
step("presigned-v4-tampered")(lambda c: c.send("GET", "/bkt/size/inline", sign="none", url=_path_of(
    auth.SigV4Verifier(lambda ak: None).presign_url(
        auth.Credentials(*ROOT), "GET", "/bkt/size/inline", [], c.host, expires=600))[:-4] + "0000"))
step("presigned-v2-get")(lambda c: c.send("GET", "/bkt/size/tiny", sign="none", url=_path_of(
    sigv2.presign_url_v2(*ROOT, "GET", "/bkt/size/tiny", c.host, expires_in=600))))
step("sigv2-header-signed-get")(lambda c: c.send("GET", "/bkt/size/tiny", sign="v2"))
step("sigv2-header-signed-put")(lambda c: c.send("PUT", "/bkt/v2/obj", body=BODIES["tiny"], sign="v2"))


def _path_of(url: str) -> str:
    u = urllib.parse.urlparse(url)
    return u.path + ("?" + u.query if u.query else "")


@step("post-policy-upload")
def _post(c: Client) -> Resp:
    body, ctype = postpolicy.build_post_form(auth.Credentials(*ROOT), "bkt", "post/obj", BODIES["post"])
    return c.send("POST", "/bkt", body=body, headers={"Content-Type": ctype}, sign="none")


@step("post-policy-wrong-key")
def _post_bad(c: Client) -> Resp:
    body, ctype = postpolicy.build_post_form(auth.Credentials(*ROOT), "bkt", "post/obj", BODIES["post"])
    body = body.replace(b"\r\n\r\npost/obj\r\n", b"\r\n\r\npost/evil\r\n", 1)
    return c.send("POST", "/bkt", body=body, headers={"Content-Type": ctype}, sign="none")


step("get-post-upload")(lambda c: _get(c, "post/obj"))

# zip extraction
step("put-zip")(lambda c: _put(c, "arch.zip", BODIES["zip"], {"Content-Type": "application/zip"}))
step("zip-get-entry")(lambda c: _get(c, "arch.zip/dir/a.txt", {"x-minio-extract": "true"}))
step("zip-head-entry")(lambda c: c.send("HEAD", "/bkt/arch.zip/dir/b.bin", headers={"x-minio-extract": "true"}))
step("zip-range-entry")(lambda c: _get(c, "arch.zip/top.txt", {"x-minio-extract": "true", "Range": "bytes=10-19"}))
step("zip-missing-entry")(lambda c: _get(c, "arch.zip/dir/none", {"x-minio-extract": "true"}))
step("zip-list")(lambda c: c.send(
    "GET", "/bkt", query=[("list-type", "2"), ("prefix", "arch.zip/"), ("delimiter", "/")],
    headers={"x-minio-extract": "true"}))

# server-side encryption
step("put-sse-c")(lambda c: _put(c, "sse/c", BODIES["sse"], _ssec_headers()))
step("get-sse-c")(lambda c: _get(c, "sse/c", _ssec_headers()))
step("get-sse-c-without-key")(lambda c: _get(c, "sse/c"))
step("head-sse-c")(lambda c: c.send("HEAD", "/bkt/sse/c", headers=_ssec_headers()))
step("range-sse-c")(lambda c: _get(c, "sse/c", {**_ssec_headers(), "Range": "bytes=-64"}))
step("put-sse-s3")(lambda c: _put(c, "sse/s3", BODIES["sse"], {"x-amz-server-side-encryption": "AES256"}))
step("get-sse-s3")(lambda c: _get(c, "sse/s3"))
step("copy-sse-c-to-sse-s3")(lambda c: c.send("PUT", "/bkt/sse/copied", headers={
    "x-amz-copy-source": "/bkt/sse/c", **_ssec_headers("copy-source-"),
    "x-amz-server-side-encryption": "AES256"}))
step("get-sse-copied")(lambda c: _get(c, "sse/copied"))

# refusals
step("wrong-signature")(lambda c: c.send("GET", "/bkt/size/tiny", sign="none", headers={
    k: (v[:-4] + "0000" if k == "authorization" else v)
    for k, v in auth.sign_request(auth.Credentials(*ROOT), "GET", "/bkt/size/tiny", [],
                                  {"host": c.host}, b"").items() if k != "host"}))
step("unknown-access-key")(lambda c: c.send("GET", "/bkt/size/tiny", sign="none", headers={
    k: v for k, v in auth.sign_request(auth.Credentials("nobody", "x"), "GET", "/bkt/size/tiny", [],
                                       {"host": c.host}, b"").items() if k != "host"}))
step("clock-skew")(lambda c: c.send(
    "GET", "/bkt/size/tiny",
    timestamp=datetime.datetime.now(datetime.timezone.utc) - datetime.timedelta(hours=1)))
step("expired-deadline-put")(lambda c: _put(c, "dl/obj", BODIES["deadline"], {"X-Mtpu-Deadline": "0.0005"}))
step("expired-deadline-absent")(lambda c: c.send("GET", "/bkt", query=[("prefix", "dl/")]))
step("delete-non-empty-bucket")(lambda c: c.send("DELETE", "/bkt"))
step("method-not-allowed")(lambda c: c.send("POST", "/bkt/size/tiny"))



def _listen(c: Client, path: str) -> Resp:
    """ListenNotification on `path`: open the stream, PUT one object under
    listen/ and read the first record the stream sends; then close it and
    delete the object. The record's eventTime (the emit's wall clock) is
    compared by its shape."""
    query = [("events", "s3:ObjectCreated:*"), ("prefix", "listen/")]
    headers = auth.sign_request(auth.Credentials(*ROOT), "GET", path, query, {"host": c.host}, b"")
    headers.pop("host")
    conn = http.client.HTTPConnection(c.host, timeout=20)
    try:
        conn.request("GET", path + "?" + urllib.parse.urlencode(query), headers=headers)
        r = conn.getresponse()
        if r.status != 200:
            return Resp(r.status, {k.lower(): v for k, v in r.getheaders()}, r.read())
        key = f"listen/{path.strip('/') or 'root'}"
        assert _put(c, key, BODIES["tiny"]).status == 200
        line = b""
        while not line.strip():
            line = r.readline()
        record = json.loads(line)
        rec = record["Records"][0]
        rec["eventTime"] = _shape(rec["eventTime"])
        return Resp(r.status, {"content-type": r.getheader("Content-Type")},
                    json.dumps(record, sort_keys=True).encode())
    finally:
        conn.close()
        c.send("DELETE", f"/bkt/listen/{path.strip('/') or 'root'}")


# ListenNotification on both fronts, each with an EventNotifier
step("listen-root")(lambda c: _listen(c, "/"))
step("listen-bucket")(lambda c: _listen(c, "/bkt"))
# routes whose answer is NotImplemented in both (hook left None)
step("restore-no-tiering")(lambda c: c.send("POST", "/bkt/size/tiny", query=[("restore", "")]))
step("replication-reset-no-replication")(lambda c: c.send("PUT", "/bkt", query=[("replication-reset", "")]))



@step("sts-assume-role")
def _sts_assume_role(c: Client) -> Resp:
    """AssumeRole signed by root; the secret key (random url-safe text)
    is replaced by its length, the other credential fields compare by shape."""
    r = c.send("POST", "/", body=b"Action=AssumeRole&Version=2011-06-15&DurationSeconds=900",
               headers={"Content-Type": "application/x-www-form-urlencoded"})
    body = re.sub(rb"<SecretAccessKey>([^<]*)</SecretAccessKey>",
                  lambda m: b"<SecretAccessKey>%d</SecretAccessKey>" % len(m.group(1)), r.body)
    return Resp(r.status, r.headers, body)


# SelectObjectContent over random bytes: the same event stream from both
step("select-object-content")(lambda c: c.send(
    "POST", "/bkt/size/tiny", query=[("select", ""), ("select-type", "2")],
    body=b"<SelectObjectContentRequest><Expression>SELECT * FROM S3Object</Expression>"
    b"<ExpressionType>SQL</ExpressionType><InputSerialization><CSV/></InputSerialization>"
    b"<OutputSerialization><CSV/></OutputSerialization></SelectObjectContentRequest>"))
# (sent to the second server of each package, the one built with a config
# whose compression subsystem is on: both fronts compress the PUT)
step("compression-config-put")(lambda c: c.send(
    "PUT", "/cbkt/notes.txt", body=b"compress me " * 200))
# Select reads the logical bytes of an encrypted and of a compressed object
# (the Stats frame counts them; cbkt's drive files are not compared)
COUNT_SELECT = (b"<SelectObjectContentRequest><Expression>SELECT count(*) FROM S3Object</Expression>"
                b"<ExpressionType>SQL</ExpressionType><InputSerialization><CSV/></InputSerialization>"
                b"<OutputSerialization><CSV/></OutputSerialization></SelectObjectContentRequest>")
SELECT_CSV = b"".join(b"%d,%d\n" % (i, i * i) for i in range(1000))
step("put-sse-s3-csv")(lambda c: c.send(
    "PUT", "/cbkt/log.csv", body=SELECT_CSV, headers={"x-amz-server-side-encryption": "AES256"}))
step("select-sse-s3")(lambda c: c.send(
    "POST", "/cbkt/log.csv", query=[("select", ""), ("select-type", "2")], body=COUNT_SELECT))
step("select-compressed")(lambda c: c.send(
    "POST", "/cbkt/notes.txt", query=[("select", ""), ("select-type", "2")], body=COUNT_SELECT))

# the last listings and the bucket list
step("list-buckets")(lambda c: c.send("GET", "/"))
step("list-v1-final")(lambda c: c.send("GET", "/bkt"))
step("list-v2-final")(lambda c: c.send("GET", "/bkt", query=[("list-type", "2")]))

STEP_NAMES = [n for n, _ in STEPS]
assert len(set(STEP_NAMES)) == len(STEP_NAMES)


class _Config:
    """A config whose compression subsystem is on (the JAX package's
    config system answers get_bool(SUBSYS_COMPRESSION, "enable"))."""

    def get_bool(self, subsys: str, key: str) -> bool:
        return (subsys, key) == ("compression", "enable")


def _stack(pkg, root: str, formats, codec):
    dirs = []
    for i, f in enumerate(formats):
        d = os.path.join(root, pkg.name, f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    drives = [pkg.LocalDrive(d) for d in dirs]
    fmt = pkg.DriveFormat.load(dirs[0])
    sets = pkg.ErasureSets.from_drives(drives, fmt, codec=codec, pool_index=0, rrs_parity=RRS_PARITY)
    return pkg.ServerPools([sets])


JAX = SimpleNamespace(
    name="jax", LocalDrive=JaxLocalDrive, DriveFormat=jax_format.DriveFormat, ErasureSets=JaxErasureSets,
    ServerPools=JaxServerPools, S3Server=JaxS3Server, ThreadedServer=JaxThreadedServer, IAMSys=JaxIAMSys,
    KMS=JaxStaticKeyKMS, EventNotifier=JaxEventNotifier,
)
PORT = SimpleNamespace(
    name="port", LocalDrive=LocalDrive, DriveFormat=port_format.DriveFormat,
    ErasureSets=minio_tpu_torch.ErasureSets, ServerPools=minio_tpu_torch.ServerPools, S3Server=S3Server,
    ThreadedServer=ThreadedServer, IAMSys=IAMSys, KMS=StaticKeyKMS, EventNotifier=EventNotifier,
)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both fronts, the script's responses from each, and the layers."""
    root = str(tmp_path_factory.mktemp("front"))
    formats = jax_format.init_format(SETS, SET_DRIVES)
    codec = BatchingDeviceCodec(device="cpu")
    codecs = {"jax": JaxHostCodec(), "port": codec}
    layers, servers, clients = {}, [], {}
    for pkg in (JAX, PORT):
        layer = _stack(pkg, root, formats, codecs[pkg.name])
        layers[pkg.name] = layer
        iam = pkg.IAMSys(*ROOT)
        kms = pkg.KMS("front-key", KMS_MASTER)
        for suffix, config in (("", None), ("-cfg", _Config())):
            srv = pkg.S3Server(layer, iam, check_skew=True, kms=kms, config=config)
            srv.notifier = pkg.EventNotifier()
            ts = pkg.ThreadedServer(srv)
            servers.append(ts)
            clients[pkg.name + suffix] = Client(pkg.name + suffix, ts.start())
    try:
        for name in ("jax-cfg", "port-cfg"):
            assert clients[name].send("PUT", "/cbkt").status == 200
        out = {"jax": {}, "port": {}}
        for name, fn in STEPS:
            for pkg in ("jax", "port"):
                c = clients[pkg + "-cfg"] if name == "compression-config-put" else clients[pkg]
                out[pkg][name] = fn(c)
        yield SimpleNamespace(resp=out, layers=layers)
    finally:
        for ts in servers:
            ts.stop()
        codec.close()


def _shape(value: str) -> str:
    return re.sub(r"[0-9a-fA-F]", "x", value)


def _xml_equal(a: ET.Element, b: ET.Element, path: str = "") -> None:
    tag = a.tag.split("}")[-1]
    here = f"{path}/{tag}"
    assert a.tag == b.tag, here
    assert a.attrib == b.attrib, here
    ta, tb = (a.text or "").strip(), (b.text or "").strip()
    if tag in RANDOM_XML:
        assert _shape(ta) == _shape(tb) and (ta == "") == (tb == ""), (here, ta, tb)
    else:
        assert ta == tb, (here, ta, tb)
    assert [c.tag for c in a] == [c.tag for c in b], here
    for ca, cb in zip(a, b):
        _xml_equal(ca, cb, here)


def _assert_same_response(j: Resp, p: Resp) -> None:
    assert p.status == j.status, (p.status, j.status, p.body[:300], j.body[:300])
    for h in HEADERS:
        assert p.headers.get(h.lower()) == j.headers.get(h.lower()), h
    if j.body.startswith(b"<?xml") or j.body.startswith(b"<"):
        _xml_equal(ET.fromstring(j.body), ET.fromstring(p.body))
    else:
        assert p.body == j.body


@pytest.mark.parametrize("name", STEP_NAMES)
def test_response_equal(run, name):
    _assert_same_response(run.resp["jax"][name], run.resp["port"][name])


# Object bodies against the seeded bytes (the equality above already holds
# them against the JAX server's).
BODY_STEPS = {
    "get-tiny": BODIES["tiny"], "get-inline": BODIES["inline"], "get-short": BODIES["short"],
    "get-rrs": BODIES["rrs"], "get-chunked": BODIES["chunked"], "get-md5-stream": BODIES["md5-stream"],
    "get-version-1": BODIES["ver1"], "get-copy": BODIES["inline"], "get-multipart-object": BODIES["part1"],
    "anonymous-get": BODIES["pub"], "presigned-v4-get": BODIES["inline"], "presigned-v2-get": BODIES["tiny"],
    "sigv2-header-signed-get": BODIES["tiny"], "get-post-upload": BODIES["post"], "get-sse-c": BODIES["sse"],
    "get-sse-s3": BODIES["sse"], "get-sse-copied": BODIES["sse"], "range-window": BODIES["inline"][100:1100],
    "range-suffix": BODIES["inline"][-100:], "range-suffix-tail-block": BODIES["multi"][-30:],
    "range-open-end": BODIES["inline"][20000:],
    "range-sse-c": BODIES["sse"][-64:],
}


@pytest.mark.parametrize("name", sorted(BODY_STEPS))
def test_body_is_the_seeded_bytes(run, name):
    assert run.resp["port"][name].body == BODY_STEPS[name]


def test_etags_fast_and_md5(run):
    """A streaming PUT without Content-MD5 gets the digest-derived etag, one
    with Content-MD5 keeps the md5 etag; inline objects keep md5."""
    port = run.resp["port"]
    assert port["put-content-md5-streaming"].headers["etag"] == f'"{hashlib.md5(BODIES["md5-stream"]).hexdigest()}"'
    assert port["put-short-block"].headers["etag"] != f'"{hashlib.md5(BODIES["short"]).hexdigest()}"'
    assert port["put-inline"].headers["etag"] == f'"{hashlib.md5(BODIES["inline"]).hexdigest()}"'
    assert port["complete-multipart"].status == 200
    assert ET.fromstring(port["complete-multipart"].body).findtext("{*}ETag").endswith('-1"')


def test_refusals(run):
    port = run.resp["port"]
    codes = {
        n: (port[n].status, ET.fromstring(port[n].body).findtext("Code"))
        for n in ("wrong-signature", "clock-skew", "expired-deadline-put", "anonymous-get-other-bucket",
                  "delete-locked-version-refused", "put-content-md5-bad", "presigned-v4-tampered")
    }
    assert codes == {
        "wrong-signature": (403, "SignatureDoesNotMatch"),
        "presigned-v4-tampered": (403, "SignatureDoesNotMatch"),
        "clock-skew": (403, "RequestTimeTooSkewed"),
        "expired-deadline-put": (503, "SlowDownWrite"),
        "anonymous-get-other-bucket": (403, "AccessDenied"),
        "delete-locked-version-refused": (403, "AccessDenied"),
        "put-content-md5-bad": (400, "BadDigest"),
    }
    assert b"dl/obj" not in port["expired-deadline-absent"].body
    assert port["if-none-match-304"].status == 304
    assert port["if-match-412"].status == 412


# -- the two drive trees ---------------------------------------------------------------

SSE_KEYS = {"sse/c", "sse/s3", "sse/copied"}
DISK_BUCKETS = ("bkt", "vbkt", "lbkt", "pbkt")


def _versions(layer, bucket: str) -> list:
    res = layer.list_object_versions(bucket, max_keys=1000)
    return [(o.name, o.version_id, o.delete_marker) for o in res.objects]


def _disk_objects(run) -> list[tuple[str, str, int]]:
    """(bucket, key, version position) of every version in the JAX tree."""
    out = []
    for bucket in DISK_BUCKETS:
        seen: dict[str, int] = {}
        for name, _, _ in _versions(run.layers["jax"], bucket):
            out.append((bucket, name, seen.setdefault(name, 0)))
            seen[name] += 1
    return out


def _on_disk(layer, bucket: str, name: str, pos: int) -> list[tuple]:
    vid = [v for n, v, _ in _versions(layer, bucket) if n == name][pos]
    sets = layer.pools[0]
    out = []
    for d in sets.sets[sets.get_set_index(name)].disks:
        fi = d.read_version(bucket, name, vid or "")
        e = fi.erasure
        fields = (
            fi.deleted, fi.size, e.data_blocks, e.parity_blocks, e.block_size, e.index, list(e.distribution),
            [(p.number, p.size, p.actual_size, p.etag) for p in fi.parts], bool(fi.data_dir),
            fi.metadata.get("etag"), fi.metadata.get("x-internal-storage-class"),
        )
        if name in SSE_KEYS or fi.deleted:
            out.append(fields)
            continue
        if fi.inline_data:
            data = b"inline:" + fi.inline_data
        else:
            with open(os.path.join(d.root, bucket, name, fi.data_dir, "part.1"), "rb") as f:
                data = f.read()
        out.append(fields + ([dict(c) for c in e.checksums], hashlib.sha256(data).hexdigest()))
    return out


def test_same_versions_in_both_trees(run):
    for bucket in DISK_BUCKETS:
        j = [(n, bool(v), dm) for n, v, dm in _versions(run.layers["jax"], bucket)]
        p = [(n, bool(v), dm) for n, v, dm in _versions(run.layers["port"], bucket)]
        assert p == j, bucket


@pytest.mark.parametrize("bucket", DISK_BUCKETS)
def test_part_files_and_xl_meta_equal(run, bucket):
    objs = [o for o in _disk_objects(run) if o[0] == bucket]
    assert objs
    for _, name, pos in objs:
        assert _on_disk(run.layers["port"], bucket, name, pos) == _on_disk(run.layers["jax"], bucket, name, pos), name
