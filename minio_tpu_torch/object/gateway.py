"""Gateway backends: ObjectLayer adapters over other stores.

Role of the reference's cmd/gateway/{s3,nas,...} (6K LoC): serve the full
S3 front (auth, IAM, policies, events — everything the handler stack adds)
while delegating object storage to another system.

  * S3Gateway — proxies to a remote S3-compatible endpoint with SigV4
    (cmd/gateway/s3/gateway-s3.go role).
  * NASGateway — the FS backend pointed at a shared mount
    (cmd/gateway/nas/gateway-nas.go is exactly this over fs-v1).

Azure/GCS/HDFS adapters are not built: their SDKs are absent in this
environment and their wire protocols are proprietary; the S3 adapter is
the reference's own recommended migration path off the others (they were
deprecated upstream).

This is the JAX package's object/gateway.py over the port's FS layer and
SigV4 signer (api/auth.py). The gateway itself builds no codec: behind an
S3 gateway, the backing deployment's own data plane encodes and verifies.
"""

from __future__ import annotations

import urllib.parse
import xml.etree.ElementTree as ET

from ..utils import errors
from .fs import FSObjectLayer, _chunks
from .types import (
    BucketInfo,
    DeleteObjectOptions,
    GetObjectOptions,
    ListObjectsInfo,
    ListObjectVersionsInfo,
    ObjectInfo,
    PutObjectOptions,
)

S3_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


class NASGateway(FSObjectLayer):
    """gateway nas: plain-file layer over a shared mount."""


class S3Gateway:
    """gateway s3: every ObjectLayer call becomes a signed S3 request to the
    backing endpoint."""

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1"):
        # mtpulint: disable=raw-transport -- gateway talks to an EXTERNAL
        # S3 endpoint; internode deadline propagation does not apply here.
        import requests

        from ..api.auth import Credentials, sign_request

        self._sign = sign_request
        self.endpoint = endpoint.rstrip("/")
        self.creds = Credentials(access_key, secret_key)
        self.region = region
        self.host = urllib.parse.urlparse(self.endpoint).netloc
        # mtpulint: disable=raw-transport -- external backend session
        self.session = requests.Session()
        self.pools = [self]
        self.ns_lock = None
        # System metadata (bucket-metadata/config blobs) stays LOCAL: the
        # backing store is someone else's bucket namespace; the reference's
        # s3 gateway likewise keeps minio.sys state out of the backend.
        self._sys: dict[str, bytes] = {}

    # -- signed wire ---------------------------------------------------------

    def _request(self, method, path, query=None, body=b"", headers=None):
        query = query or []
        headers = dict(headers or {})
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers["host"] = self.host
        signed = self._sign(
            self.creds, method, path, query, headers, body, region=self.region
        )
        signed.pop("host", None)
        return self.session.request(method, url, data=body, headers=signed, timeout=30)

    @staticmethod
    def _err(r, bucket: str = "", object_name: str = ""):
        if r.status_code == 404:
            if object_name:
                raise errors.ObjectNotFound(bucket, object_name)
            raise errors.BucketNotFound(bucket)
        if r.status_code == 409:
            raise errors.BucketExists(bucket)
        raise errors.StorageError(f"backend S3: HTTP {r.status_code}: {r.text[:200]}")

    # -- buckets -------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        r = self._request("PUT", f"/{bucket}")
        if r.status_code != 200:
            self._err(r, bucket)

    def bucket_exists(self, bucket: str) -> bool:
        return self._request("HEAD", f"/{bucket}").status_code == 200

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        if not self.bucket_exists(bucket):
            raise errors.BucketNotFound(bucket)
        return BucketInfo(name=bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        r = self._request("DELETE", f"/{bucket}")
        if r.status_code not in (200, 204):
            if r.status_code == 409:
                raise errors.BucketNotEmpty(bucket)
            self._err(r, bucket)

    def list_buckets(self) -> list[BucketInfo]:
        r = self._request("GET", "/")
        if r.status_code != 200:
            self._err(r)
        out = []
        for b in ET.fromstring(r.content).iter(f"{S3_NS}Bucket"):
            out.append(BucketInfo(name=b.findtext(f"{S3_NS}Name") or ""))
        return out

    # -- objects -------------------------------------------------------------

    def put_object(
        self, bucket: str, object_name: str, data: bytes,
        opts: PutObjectOptions | None = None,
    ) -> ObjectInfo:
        opts = opts or PutObjectOptions()
        if bucket.startswith("."):
            self._sys[f"{bucket}/{object_name}"] = bytes(data)
            return ObjectInfo(bucket=bucket, name=object_name, size=len(data))
        headers = {"content-type": opts.content_type}
        for k, v in opts.user_defined.items():
            if k.startswith("x-amz-meta-") or not k.startswith("x-"):
                headers[k if k.startswith("x-amz-meta-") else f"x-amz-meta-{k}"] = v
        r = self._request("PUT", f"/{bucket}/{object_name}", body=data, headers=headers)
        if r.status_code != 200:
            self._err(r, bucket, object_name)
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=len(data),
            etag=r.headers.get("ETag", "").strip('"'),
            version_id=r.headers.get("x-amz-version-id", ""),
        )

    def _info_from_headers(self, bucket, object_name, r) -> ObjectInfo:
        user = {
            k.lower(): v for k, v in r.headers.items() if k.lower().startswith("x-amz-meta-")
        }
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=int(r.headers.get("Content-Length", "0") or 0),
            etag=r.headers.get("ETag", "").strip('"'),
            content_type=r.headers.get("Content-Type", "application/octet-stream"),
            version_id=r.headers.get("x-amz-version-id", ""),
            user_defined=user,
        )

    def get_object_info(
        self, bucket: str, object_name: str, opts: GetObjectOptions | None = None
    ) -> ObjectInfo:
        opts = opts or GetObjectOptions()
        q = [("versionId", opts.version_id)] if opts.version_id else []
        r = self._request("HEAD", f"/{bucket}/{object_name}", query=q)
        if r.status_code != 200:
            self._err(r, bucket, object_name)
        return self._info_from_headers(bucket, object_name, r)

    def get_object(
        self, bucket: str, object_name: str,
        opts: GetObjectOptions | None = None, offset: int = 0, length: int = -1,
    ) -> tuple[ObjectInfo, bytes]:
        if bucket.startswith("."):
            key = f"{bucket}/{object_name}"
            if key not in self._sys:
                raise errors.ObjectNotFound(bucket, object_name)
            data = self._sys[key]
            return ObjectInfo(bucket=bucket, name=object_name, size=len(data)), data
        opts = opts or GetObjectOptions()
        q = [("versionId", opts.version_id)] if opts.version_id else []
        headers = {}
        if (offset, length) != (0, -1):
            end = "" if length < 0 else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = self._request("GET", f"/{bucket}/{object_name}", query=q, headers=headers)
        if r.status_code not in (200, 206):
            self._err(r, bucket, object_name)
        return self._info_from_headers(bucket, object_name, r), r.content

    def put_object_metadata(
        self, bucket, object_name, version_id: str = "", updates=None, removes=None
    ) -> ObjectInfo:
        # S3 metadata replace = self-copy with REPLACE directive.
        oi = self.get_object_info(bucket, object_name)
        meta = dict(oi.user_defined)
        for k in removes or []:
            meta.pop(k, None)
        meta.update(updates or {})
        headers = {
            "x-amz-copy-source": f"/{bucket}/{object_name}",
            "x-amz-metadata-directive": "REPLACE",
            **meta,
        }
        r = self._request("PUT", f"/{bucket}/{object_name}", headers=headers)
        if r.status_code != 200:
            self._err(r, bucket, object_name)
        return self.get_object_info(bucket, object_name)

    def delete_object(
        self, bucket: str, object_name: str, opts: DeleteObjectOptions | None = None
    ) -> ObjectInfo:
        if bucket.startswith("."):
            self._sys.pop(f"{bucket}/{object_name}", None)
            return ObjectInfo(bucket=bucket, name=object_name)
        opts = opts or DeleteObjectOptions()
        q = [("versionId", opts.version_id)] if opts.version_id else []
        r = self._request("DELETE", f"/{bucket}/{object_name}", query=q)
        if r.status_code not in (200, 204):
            self._err(r, bucket, object_name)
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            delete_marker=r.headers.get("x-amz-delete-marker", "") == "true",
            version_id=r.headers.get("x-amz-version-id", ""),
        )

    def delete_objects(self, bucket: str, objects, versioned: bool = False):
        out = []
        for name, vid in objects:
            try:
                out.append(
                    (self.delete_object(bucket, name, DeleteObjectOptions(version_id=vid)), None)
                )
            except errors.StorageError as e:
                out.append((None, e))
        return out

    # -- listing -------------------------------------------------------------

    def list_objects(
        self, bucket: str, prefix: str = "", marker: str = "",
        delimiter: str = "", max_keys: int = 1000,
    ) -> ListObjectsInfo:
        q = [("list-type", "2"), ("prefix", prefix), ("max-keys", str(max_keys))]
        if delimiter:
            q.append(("delimiter", delimiter))
        if marker:
            q.append(("start-after", marker))
        r = self._request("GET", f"/{bucket}", query=q)
        if r.status_code != 200:
            self._err(r, bucket)
        root = ET.fromstring(r.content)
        res = ListObjectsInfo(
            is_truncated=(root.findtext(f"{S3_NS}IsTruncated") == "true"),
        )
        for c in root.findall(f"{S3_NS}Contents"):
            res.objects.append(
                ObjectInfo(
                    bucket=bucket,
                    name=c.findtext(f"{S3_NS}Key") or "",
                    size=int(c.findtext(f"{S3_NS}Size") or 0),
                    etag=(c.findtext(f"{S3_NS}ETag") or "").strip('"'),
                )
            )
        for p in root.findall(f"{S3_NS}CommonPrefixes"):
            res.prefixes.append(p.findtext(f"{S3_NS}Prefix") or "")
        if res.objects:
            res.next_marker = res.objects[-1].name
        return res

    def list_object_versions(
        self, bucket: str, prefix: str = "", key_marker: str = "",
        version_marker: str = "", delimiter: str = "", max_keys: int = 1000,
    ) -> ListObjectVersionsInfo:
        listing = self.list_objects(bucket, prefix, key_marker, delimiter, max_keys)
        return ListObjectVersionsInfo(
            is_truncated=listing.is_truncated,
            next_key_marker=listing.next_marker,
            objects=listing.objects,
            prefixes=listing.prefixes,
        )

    # -- multipart (proxied straight through) ---------------------------------

    def new_multipart_upload(
        self, bucket: str, object_name: str, opts: PutObjectOptions | None = None
    ) -> str:
        r = self._request("POST", f"/{bucket}/{object_name}", query=[("uploads", "")])
        if r.status_code != 200:
            self._err(r, bucket, object_name)
        return ET.fromstring(r.content).findtext(f"{S3_NS}UploadId") or ""

    def put_object_part(self, bucket, object_name, upload_id, part_number, data):
        """data: bytes or a .read(n) stream (the S3 front streams every part;
        the JAX package's gateway takes bytes only), sent as one body."""
        from ..storage.types import ObjectPartInfo

        data = b"".join(_chunks(data))
        r = self._request(
            "PUT",
            f"/{bucket}/{object_name}",
            query=[("partNumber", str(part_number)), ("uploadId", upload_id)],
            body=data,
        )
        if r.status_code != 200:
            self._err(r, bucket, object_name)
        return ObjectPartInfo(
            part_number, len(data), len(data), 0.0, r.headers.get("ETag", "").strip('"')
        )

    def list_parts(self, bucket, object_name, upload_id, part_marker=0, max_parts=1000):
        from ..storage.types import ObjectPartInfo

        r = self._request(
            "GET", f"/{bucket}/{object_name}", query=[("uploadId", upload_id)]
        )
        if r.status_code != 200:
            self._err(r, bucket, object_name)
        out = []
        for p in ET.fromstring(r.content).findall(f"{S3_NS}Part"):
            out.append(
                ObjectPartInfo(
                    int(p.findtext(f"{S3_NS}PartNumber") or 0),
                    int(p.findtext(f"{S3_NS}Size") or 0),
                    int(p.findtext(f"{S3_NS}Size") or 0),
                    0.0,
                    (p.findtext(f"{S3_NS}ETag") or "").strip('"'),
                )
            )
        return [p for p in out if p.number > part_marker][:max_parts]

    def complete_multipart_upload(self, bucket, object_name, upload_id, parts):
        body = (
            "<CompleteMultipartUpload>"
            + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{etag}</ETag></Part>"
                for n, etag in parts
            )
            + "</CompleteMultipartUpload>"
        ).encode()
        r = self._request(
            "POST", f"/{bucket}/{object_name}", query=[("uploadId", upload_id)], body=body
        )
        if r.status_code != 200:
            self._err(r, bucket, object_name)
        return self.get_object_info(bucket, object_name)

    def abort_multipart_upload(self, bucket, object_name, upload_id) -> None:
        r = self._request(
            "DELETE", f"/{bucket}/{object_name}", query=[("uploadId", upload_id)]
        )
        if r.status_code not in (200, 204):
            self._err(r, bucket, object_name)

    def list_multipart_uploads(self, bucket: str, prefix: str = "") -> list[dict]:
        r = self._request("GET", f"/{bucket}", query=[("uploads", ""), ("prefix", prefix)])
        if r.status_code != 200:
            self._err(r, bucket)
        out = []
        for u in ET.fromstring(r.content).findall(f"{S3_NS}Upload"):
            out.append(
                {
                    "upload_id": u.findtext(f"{S3_NS}UploadId") or "",
                    "object": u.findtext(f"{S3_NS}Key") or "",
                    "initiated": 0.0,
                }
            )
        return out

    # -- heal: delegated store owns durability --------------------------------

    def heal_bucket(self, bucket: str) -> None:
        self.get_bucket_info(bucket)

    def heal_object(self, bucket, object_name, version_id="", dry_run=False):
        from .types import HealResultItem

        self.get_object_info(bucket, object_name)
        return HealResultItem(bucket=bucket, object=object_name)
