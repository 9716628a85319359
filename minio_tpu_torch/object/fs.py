"""FS backend: single-mount plain-file ObjectLayer (no erasure).

Role of the reference's fs-v1 backend (cmd/fs-v1.go:119 NewFSObjectLayer,
fs-v1-multipart.go, fs-v1-metadata.go, format-fs.go): objects are plain
files under <root>/<bucket>/<object>, per-object metadata lives in an
`fs.json` analogue under the sys prefix, multipart parts stage under the
sys prefix and concatenate on complete. Selected for single-path
deployments (server-main.go:636-643 picks FS for one endpoint).
Versioning is not supported (as in the reference's FS mode); versioned
requests behave as unversioned with a "null" version id.

The NAS gateway (cmd/gateway/nas) is this same layer pointed at a shared
mount — see gateway.py.

This is the JAX package's object/fs.py: the same `.minio_tpu.sys` layout
(format-fs.json, fs-meta documents, fs-multipart staging), so a directory
written by either package is served by the other. No codec and no device
path: the reference's FS mode runs no erasure.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import time
import uuid

from ..storage.local import FSYNC_NEVER, fsync_mode
from ..storage.types import ObjectPartInfo
from ..utils import errors
from .types import (
    BucketInfo,
    DeleteObjectOptions,
    GetObjectOptions,
    HealResultItem,
    ListObjectsInfo,
    ListObjectVersionsInfo,
    ObjectInfo,
    PutObjectOptions,
)

SYS_PREFIX = ".minio_tpu.sys"
META_DIR = os.path.join(SYS_PREFIX, "fs-meta")
MULTIPART_DIR = os.path.join(SYS_PREFIX, "fs-multipart")
FORMAT_FILE = os.path.join(SYS_PREFIX, "format-fs.json")


def _chunks(data, size: int = 1 << 20):
    """The bytes of `data`: bytes-like as one chunk, a .read(n) stream in
    chunks of `size`."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        yield bytes(data)
        return
    while chunk := data.read(size):
        yield chunk


def _valid_bucket(bucket: str) -> bool:
    return bool(bucket) and not bucket.startswith(".") and "/" not in bucket


class FSObjectLayer:
    """ObjectLayer over one filesystem path (fs-v1.go fsObjects role)."""

    supports_streaming = True  # put_object accepts .read(n) streams

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, SYS_PREFIX), exist_ok=True)
        fmt = os.path.join(root, FORMAT_FILE)
        if not os.path.exists(fmt):
            with open(fmt, "w") as f:
                json.dump({"version": 1, "format": "fs", "id": str(uuid.uuid4())}, f)
        # ConfigStore and friends address layer.pools[0]; the FS layer is its
        # own single pool.
        self.pools = [self]
        self.ns_lock = None

    # -- paths ---------------------------------------------------------------

    def _bucket_path(self, bucket: str) -> str:
        return os.path.join(self.root, bucket)

    def _obj_path(self, bucket: str, object_name: str) -> str:
        p = os.path.normpath(os.path.join(self._bucket_path(bucket), object_name))
        if not p.startswith(os.path.normpath(self._bucket_path(bucket)) + os.sep):
            raise errors.InvalidArgument(msg=f"invalid object name {object_name!r}")
        return p

    def _meta_path(self, bucket: str, object_name: str) -> str:
        return os.path.join(self.root, META_DIR, bucket, object_name + ".json")

    def _check_bucket(self, bucket: str) -> None:
        if not os.path.isdir(self._bucket_path(bucket)):
            raise errors.BucketNotFound(bucket)

    # -- buckets -------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        if not _valid_bucket(bucket) and bucket != SYS_PREFIX and not bucket.startswith("."):
            raise errors.InvalidArgument(msg=f"invalid bucket name {bucket!r}")
        p = self._bucket_path(bucket)
        if os.path.isdir(p):
            raise errors.BucketExists(bucket)
        os.makedirs(p)

    def bucket_exists(self, bucket: str) -> bool:
        return os.path.isdir(self._bucket_path(bucket))

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        self._check_bucket(bucket)
        st = os.stat(self._bucket_path(bucket))
        return BucketInfo(name=bucket, created=st.st_mtime)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self._check_bucket(bucket)
        p = self._bucket_path(bucket)
        if not force and any(os.scandir(p)):
            raise errors.BucketNotEmpty(bucket)
        shutil.rmtree(p)
        shutil.rmtree(os.path.join(self.root, META_DIR, bucket), ignore_errors=True)

    def list_buckets(self) -> list[BucketInfo]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("."):
                continue
            p = os.path.join(self.root, name)
            if os.path.isdir(p):
                out.append(BucketInfo(name=name, created=os.stat(p).st_mtime))
        return out

    # -- objects -------------------------------------------------------------

    def put_object(
        self, bucket: str, object_name: str, data,
        opts: PutObjectOptions | None = None,
    ) -> ObjectInfo:
        """data: bytes or a .read(n) stream (streamed straight to disk)."""
        opts = opts or PutObjectOptions()
        self._check_bucket(bucket)
        path = self._obj_path(bucket, object_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp-{uuid.uuid4().hex}"
        md5h = hashlib.md5()
        size = 0
        try:
            with open(tmp, "wb") as f:
                for chunk in _chunks(data):
                    f.write(chunk)
                    md5h.update(chunk)
                    size += len(chunk)
                if fsync_mode() != FSYNC_NEVER:
                    f.flush()
                    os.fsync(f.fileno())
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
        os.replace(tmp, path)  # atomic commit (fs-v1 putObject rename)
        etag = opts.etag or md5h.hexdigest()
        meta = {
            "etag": etag,
            "content_type": opts.content_type,
            "mod_time": time.time(),
            "size": size,
            "user_defined": dict(opts.user_defined),
        }
        mp = self._meta_path(bucket, object_name)
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        mtmp = mp + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f)
            if fsync_mode() != FSYNC_NEVER:
                f.flush()
                os.fsync(f.fileno())
        os.replace(mtmp, mp)
        return self._info(bucket, object_name, meta)

    def _load_meta(self, bucket: str, object_name: str) -> dict:
        try:
            with open(self._meta_path(bucket, object_name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _info(self, bucket: str, object_name: str, meta: dict | None = None) -> ObjectInfo:
        path = self._obj_path(bucket, object_name)
        try:
            st = os.stat(path)
        except FileNotFoundError:
            raise errors.ObjectNotFound(bucket, object_name)
        if os.path.isdir(path):
            raise errors.ObjectNotFound(bucket, object_name)
        meta = meta if meta is not None else self._load_meta(bucket, object_name)
        user = dict(meta.get("user_defined", {}))
        return ObjectInfo(
            bucket=bucket,
            name=object_name,
            size=st.st_size,
            mod_time=meta.get("mod_time", st.st_mtime),
            etag=meta.get("etag", ""),
            content_type=meta.get("content_type", "application/octet-stream"),
            user_defined={k: v for k, v in user.items() if not k.startswith("x-internal-")},
            internal={k: v for k, v in user.items() if k.startswith("x-internal-")},
            version_id="",  # FS mode is unversioned
        )

    def get_object_info(
        self, bucket: str, object_name: str, opts: GetObjectOptions | None = None
    ) -> ObjectInfo:
        self._check_bucket(bucket)
        return self._info(bucket, object_name)

    def get_object(
        self, bucket: str, object_name: str,
        opts: GetObjectOptions | None = None, offset: int = 0, length: int = -1,
    ) -> tuple[ObjectInfo, bytes]:
        oi = self.get_object_info(bucket, object_name, opts)
        with open(self._obj_path(bucket, object_name), "rb") as f:
            if offset:
                f.seek(offset)
            data = f.read() if length < 0 else f.read(length)
        return oi, data

    def get_object_stream(
        self, bucket: str, object_name: str,
        opts: GetObjectOptions | None = None, offset: int = 0, length: int = -1,
    ):
        """(ObjectInfo, chunk iterator) — plain-file chunked reads."""
        oi = self.get_object_info(bucket, object_name, opts)
        end = oi.size if length < 0 else min(offset + length, oi.size)
        path = self._obj_path(bucket, object_name)

        def gen():
            remaining = end - offset
            if remaining <= 0:
                return
            with open(path, "rb") as f:
                f.seek(offset)
                while remaining > 0:
                    chunk = f.read(min(1 << 20, remaining))
                    if not chunk:
                        return
                    remaining -= len(chunk)
                    yield chunk

        return oi, gen()

    def put_object_metadata(
        self, bucket: str, object_name: str, version_id: str = "",
        updates: dict | None = None, removes: list | None = None,
    ) -> ObjectInfo:
        self._check_bucket(bucket)
        self._info(bucket, object_name)
        meta = self._load_meta(bucket, object_name)
        user = meta.setdefault("user_defined", {})
        for k in removes or []:
            user.pop(k, None)
        user.update(updates or {})
        mp = self._meta_path(bucket, object_name)
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        with open(mp, "w") as f:
            json.dump(meta, f)
        return self._info(bucket, object_name, meta)

    def delete_object(
        self, bucket: str, object_name: str, opts: DeleteObjectOptions | None = None
    ) -> ObjectInfo:
        self._check_bucket(bucket)
        path = self._obj_path(bucket, object_name)
        try:
            os.remove(path)
        except FileNotFoundError:
            raise errors.ObjectNotFound(bucket, object_name)
        except IsADirectoryError:
            raise errors.ObjectNotFound(bucket, object_name)
        try:
            os.remove(self._meta_path(bucket, object_name))
        except OSError:
            pass
        # Trim now-empty parent dirs (plain FS keeps no empty prefixes).
        parent = os.path.dirname(path)
        stop = self._bucket_path(bucket)
        while parent != stop and os.path.isdir(parent) and not os.listdir(parent):
            os.rmdir(parent)
            parent = os.path.dirname(parent)
        return ObjectInfo(bucket=bucket, name=object_name)

    def delete_objects(self, bucket: str, objects, versioned: bool = False):
        out = []
        for name, _vid in objects:
            try:
                out.append((self.delete_object(bucket, name), None))
            except errors.StorageError as e:
                out.append((None, e))
        return out

    # -- listing -------------------------------------------------------------

    def _walk(self, bucket: str):
        """Yield object names in full-key lexicographic order (S3 listing
        contract): directories recurse in place, sorted with a trailing '/'
        so 'dir.txt' < 'dir/... ' compares like the flat keys do."""
        base = self._bucket_path(bucket)

        def recurse(d: str, rel: str):
            try:
                entries = list(os.scandir(d))
            except OSError:
                return
            entries.sort(key=lambda e: e.name + "/" if e.is_dir() else e.name)
            for e in entries:
                if e.is_dir():
                    yield from recurse(e.path, rel + e.name + "/")
                elif ".tmp-" not in e.name:
                    yield rel + e.name

        yield from recurse(base, "")

    def list_objects(
        self, bucket: str, prefix: str = "", marker: str = "",
        delimiter: str = "", max_keys: int = 1000,
    ) -> ListObjectsInfo:
        self._check_bucket(bucket)
        res = ListObjectsInfo()
        seen_prefixes: set[str] = set()
        count = 0
        for name in self._walk(bucket):
            if not name.startswith(prefix):
                continue
            display = name
            if delimiter:
                rest = name[len(prefix):]
                cut = rest.find(delimiter)
                if cut >= 0:
                    display = prefix + rest[: cut + len(delimiter)]
                    if display in seen_prefixes or (marker and display <= marker):
                        continue
                    if count >= max_keys:
                        res.is_truncated = True
                        res.next_marker = name
                        break
                    seen_prefixes.add(display)
                    res.prefixes.append(display)
                    count += 1
                    continue
            if marker and name <= marker:
                continue
            if count >= max_keys:
                res.is_truncated = True
                res.next_marker = name
                break
            res.objects.append(self._info(bucket, name))
            count += 1
        if res.is_truncated and not res.next_marker:
            last = res.objects[-1].name if res.objects else ""
            res.next_marker = last
        return res

    def list_object_versions(
        self, bucket: str, prefix: str = "", key_marker: str = "",
        version_marker: str = "", delimiter: str = "", max_keys: int = 1000,
    ) -> ListObjectVersionsInfo:
        listing = self.list_objects(bucket, prefix, key_marker, delimiter, max_keys)
        out = ListObjectVersionsInfo(
            is_truncated=listing.is_truncated,
            next_key_marker=listing.next_marker,
            prefixes=listing.prefixes,
        )
        for o in listing.objects:
            o.version_id = "null"
            out.objects.append(o)
        return out

    # -- multipart (fs-v1-multipart.go role) ----------------------------------

    def _upload_dir(self, upload_id: str) -> str:
        return os.path.join(self.root, MULTIPART_DIR, upload_id)

    def new_multipart_upload(
        self, bucket: str, object_name: str, opts: PutObjectOptions | None = None
    ) -> str:
        opts = opts or PutObjectOptions()
        self._check_bucket(bucket)
        upload_id = uuid.uuid4().hex
        d = self._upload_dir(upload_id)
        os.makedirs(d)
        with open(os.path.join(d, "upload.json"), "w") as f:
            json.dump(
                {
                    "bucket": bucket,
                    "object": object_name,
                    "initiated": time.time(),
                    "content_type": opts.content_type,
                    "user_defined": dict(opts.user_defined),
                },
                f,
            )
        return upload_id

    def _upload_info(self, bucket: str, object_name: str, upload_id: str) -> dict:
        try:
            with open(os.path.join(self._upload_dir(upload_id), "upload.json")) as f:
                info = json.load(f)
        except (OSError, ValueError):
            raise errors.InvalidUploadID(bucket, object_name, msg=f"upload {upload_id}")
        if info["bucket"] != bucket or info["object"] != object_name:
            raise errors.InvalidUploadID(bucket, object_name, msg=f"upload {upload_id}")
        return info

    def put_object_part(
        self, bucket: str, object_name: str, upload_id: str, part_number: int, data
    ):
        """data: bytes or a .read(n) stream, as put_object takes: the S3 front
        streams every part. (The JAX package's takes bytes only, so a part
        PUT through its front answers 500 there.)"""
        self._upload_info(bucket, object_name, upload_id)
        md5h = hashlib.md5()
        size = 0
        with open(os.path.join(self._upload_dir(upload_id), f"part.{part_number}"), "wb") as f:
            for chunk in _chunks(data):
                f.write(chunk)
                md5h.update(chunk)
                size += len(chunk)
        etag = md5h.hexdigest()
        with open(
            os.path.join(self._upload_dir(upload_id), f"part.{part_number}.json"), "w"
        ) as f:
            json.dump({"etag": etag, "size": size, "mod_time": time.time()}, f)
        return ObjectPartInfo(part_number, size, size, time.time(), etag)

    def list_parts(
        self, bucket: str, object_name: str, upload_id: str,
        part_marker: int = 0, max_parts: int = 1000,
    ) -> list[ObjectPartInfo]:
        self._upload_info(bucket, object_name, upload_id)
        d = self._upload_dir(upload_id)
        parts = []
        for name in os.listdir(d):
            if name.startswith("part.") and name.endswith(".json"):
                n = int(name.split(".")[1])
                if n <= part_marker:
                    continue
                with open(os.path.join(d, name)) as f:
                    meta = json.load(f)
                parts.append(
                    ObjectPartInfo(
                        n, meta["size"], meta["size"], meta.get("mod_time", 0.0), meta["etag"]
                    )
                )
        parts.sort(key=lambda p: p.number)
        return parts[:max_parts]

    def complete_multipart_upload(
        self, bucket: str, object_name: str, upload_id: str, parts: list[tuple[int, str]]
    ) -> ObjectInfo:
        info = self._upload_info(bucket, object_name, upload_id)
        d = self._upload_dir(upload_id)
        blob = b""
        md5s = b""
        for n, etag in parts:
            try:
                with open(os.path.join(d, f"part.{n}.json")) as f:
                    meta = json.load(f)
            except OSError:
                raise errors.InvalidPart(bucket, object_name, msg=f"part {n} missing")
            if meta["etag"] != etag.strip('"').strip():
                raise errors.InvalidPart(bucket, object_name, msg=f"part {n} etag mismatch")
            with open(os.path.join(d, f"part.{n}"), "rb") as f:
                blob += f.read()
            md5s += bytes.fromhex(meta["etag"])
        final_etag = f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"
        opts = PutObjectOptions(
            user_defined=dict(info.get("user_defined", {})),
            content_type=info.get("content_type", "application/octet-stream"),
            etag=final_etag,
        )
        oi = self.put_object(bucket, object_name, blob, opts)
        shutil.rmtree(d, ignore_errors=True)
        return oi

    def abort_multipart_upload(self, bucket: str, object_name: str, upload_id: str) -> None:
        self._upload_info(bucket, object_name, upload_id)
        shutil.rmtree(self._upload_dir(upload_id), ignore_errors=True)

    def list_multipart_uploads(self, bucket: str, prefix: str = "") -> list[dict]:
        base = os.path.join(self.root, MULTIPART_DIR)
        out = []
        if not os.path.isdir(base):
            return out
        for upload_id in os.listdir(base):
            try:
                with open(os.path.join(base, upload_id, "upload.json")) as f:
                    info = json.load(f)
            except (OSError, ValueError):
                continue
            if info["bucket"] == bucket and info["object"].startswith(prefix):
                out.append(
                    {
                        "upload_id": upload_id,
                        "object": info["object"],
                        "initiated": info["initiated"],
                    }
                )
        return sorted(out, key=lambda u: (u["object"], u["initiated"]))

    # -- heal (no redundancy on FS: no-ops, like the reference's fs backend) --

    def heal_bucket(self, bucket: str) -> None:
        self._check_bucket(bucket)

    def heal_object(
        self, bucket: str, object_name: str, version_id: str = "", dry_run: bool = False
    ) -> HealResultItem:
        self._info(bucket, object_name)
        return HealResultItem(bucket=bucket, object=object_name)
