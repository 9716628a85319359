"""Disk cache: SSD read-cache interposed before the object layer.

Role of the reference's CacheObjectLayer (cmd/disk-cache.go:82,
disk-cache-backend.go, format-disk-cache.go): GETs are served from local
cache drives once an object has been requested `after` times; cached
entries carry their own metadata (`cache.json` analogue) and are validated
against the backend's ETag when the backend is online, served stale when it
is offline; an LRU garbage collector trims the cache between high/low
watermarks; PUT/DELETE invalidate. Objects are spread across cache drives
by name hash (disk-cache.go consistent drive pick).

TPU framing: the cache is pure host-side IO — it exists to keep hot GETs
off the erasure decode path entirely (no device work at all on a hit).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

from ..utils import errors
from .types import GetObjectOptions, ObjectInfo
from ..control.sanitizer import san_lock, san_rlock

CACHE_DATA = "part.1"
CACHE_META = "cache.json"
CACHE_ENV_DRIVES = "MTPU_CACHE_DRIVES"
CACHE_ENV_AFTER = "MTPU_CACHE_AFTER"
CACHE_ENV_QUOTA = "MTPU_CACHE_QUOTA"
CACHE_ENV_EXCLUDE = "MTPU_CACHE_EXCLUDE"


class CacheConfig:
    """cache subsystem config (internal/config/cache equivalent)."""

    def __init__(
        self,
        drives: list[str],
        after: int = 0,
        quota_bytes: int = 0,
        watermark_low: float = 0.7,
        watermark_high: float = 0.8,
        exclude: list[str] | None = None,
    ):
        self.drives = drives
        # Cache an object only after it was requested `after` times
        # (MINIO_CACHE_AFTER); 0 = first GET caches.
        self.after = after
        # Hard byte budget per cache drive (stands in for the reference's
        # percentage-of-filesystem quota, which needs statvfs of a dedicated
        # cache disk; a byte budget is exact for shared test filesystems).
        self.quota_bytes = quota_bytes or 1 << 30
        self.watermark_low = watermark_low
        self.watermark_high = watermark_high
        self.exclude = exclude or []

    @classmethod
    def from_env(cls, env=os.environ) -> "CacheConfig | None":
        raw = env.get(CACHE_ENV_DRIVES, "")
        if not raw:
            return None
        return cls(
            drives=[d for d in raw.split(",") if d],
            after=int(env.get(CACHE_ENV_AFTER, "0") or 0),
            quota_bytes=int(env.get(CACHE_ENV_QUOTA, "0") or 0),
            exclude=[p for p in env.get(CACHE_ENV_EXCLUDE, "").split(",") if p],
        )


class _CacheDrive:
    """One cache directory: entries + usage accounting + LRU GC."""

    def __init__(self, root: str, cfg: CacheConfig):
        self.root = root
        self.cfg = cfg
        self._lock = san_lock("_CacheDrive._lock")
        os.makedirs(root, exist_ok=True)
        # Format marker (format-disk-cache.go role): refuse directories that
        # belong to a different subsystem.
        marker = os.path.join(root, "format.cache.json")
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                json.dump({"version": 1, "format": "cache"}, f)

    def _entry_dir(self, bucket: str, obj: str, rng: str = "") -> str:
        key = f"{bucket}/{obj}"
        h = hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self.root, h[:2], h + (("_" + rng) if rng else ""))

    # -- read ---------------------------------------------------------------

    def lookup(self, bucket: str, obj: str, rng: str = "") -> tuple[dict, bytes] | None:
        d = self._entry_dir(bucket, obj, rng)
        try:
            with open(os.path.join(d, CACHE_META)) as f:
                meta = json.load(f)
            with open(os.path.join(d, CACHE_DATA), "rb") as f:
                data = f.read()
        except (OSError, ValueError):
            return None
        meta["atime"] = time.time()
        meta["hits"] = meta.get("hits", 0) + 1
        self._write_meta(d, meta)
        return meta, data

    def peek(self, bucket: str, obj: str, rng: str = "") -> dict | None:
        try:
            with open(os.path.join(self._entry_dir(bucket, obj, rng), CACHE_META)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_meta(self, d: str, meta: dict) -> None:
        tmp = os.path.join(d, CACHE_META + ".tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(meta, f)
            # mtpulint: disable=unsynced-commit -- cache entries are
            # best-effort and rebuilt from the backend on miss; a torn meta
            # file just reads as a miss, so an fsync here buys nothing.
            os.replace(tmp, os.path.join(d, CACHE_META))
        except OSError:
            pass

    # -- write --------------------------------------------------------------

    def save(self, bucket: str, obj: str, oi: ObjectInfo, data: bytes, rng: str = "") -> None:
        if len(data) > self.cfg.quota_bytes:
            return
        d = self._entry_dir(bucket, obj, rng)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, CACHE_DATA), "wb") as f:
            f.write(data)
        self._write_meta(
            d,
            {
                "bucket": bucket,
                "object": obj,
                "range": rng,
                "etag": oi.etag,
                "version_id": oi.version_id,
                "mod_time": oi.mod_time,
                "size": len(data),
                "content_type": oi.content_type,
                "user_defined": dict(oi.user_defined),
                # Transform state (SSE-S3/compression markers) MUST survive:
                # the handler's decrypt/decompress path keys off internal.
                "internal": dict(oi.internal),
                "actual_size": oi.actual_size,
                "cached_at": time.time(),
                "atime": time.time(),
                "hits": 1,
            },
        )
        self.maybe_gc()

    def invalidate(self, bucket: str, obj: str) -> None:
        base = self._entry_dir(bucket, obj)
        parent = os.path.dirname(base)
        prefix = os.path.basename(base)
        try:
            for name in os.listdir(parent):
                if name == prefix or name.startswith(prefix + "_"):
                    shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
        except OSError:
            pass

    # -- GC (disk-cache-backend.go LRU watermarks) ---------------------------

    def usage(self) -> int:
        total = 0
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    pass
        return total

    def maybe_gc(self) -> None:
        with self._lock:
            if self.usage() <= self.cfg.quota_bytes * self.cfg.watermark_high:
                return
            entries = []
            for sub in os.listdir(self.root):
                subp = os.path.join(self.root, sub)
                if not os.path.isdir(subp):
                    continue
                for ent in os.listdir(subp):
                    d = os.path.join(subp, ent)
                    try:
                        with open(os.path.join(d, CACHE_META)) as f:
                            meta = json.load(f)
                        entries.append((meta.get("atime", 0), meta.get("size", 0), d))
                    except (OSError, ValueError):
                        shutil.rmtree(d, ignore_errors=True)
            entries.sort()  # least-recently-used first
            used = sum(size for _, size, _ in entries)
            target = self.cfg.quota_bytes * self.cfg.watermark_low
            for _atime, size, d in entries:
                if used <= target:
                    break
                shutil.rmtree(d, ignore_errors=True)
                used -= size


class CacheObjectLayer:
    """Transparent read-cache wrapper around an ObjectLayer
    (cmd/disk-cache.go CacheObjectLayer; interposed at the handler layer in
    the reference, object-handlers.go:1722-1724)."""

    def __init__(self, backend, cfg: CacheConfig):
        self.backend = backend
        self.cfg = cfg
        self.drives = [_CacheDrive(d, cfg) for d in cfg.drives]
        # Pending-cache hit counters for the `after` threshold.
        self._hit_counts: dict[str, int] = {}
        self._hits = 0
        self._misses = 0

    # Everything not overridden passes straight through to the backend.
    def __getattr__(self, name):
        return getattr(self.backend, name)

    # -- drive pick ----------------------------------------------------------

    def _drive(self, bucket: str, obj: str) -> _CacheDrive | None:
        if not self.drives:
            return None
        key = hashlib.sha256(f"{bucket}/{obj}".encode()).digest()
        return self.drives[int.from_bytes(key[:4], "big") % len(self.drives)]

    def _excluded(self, bucket: str, obj: str) -> bool:
        target = f"{bucket}/{obj}"
        for pat in self.cfg.exclude:
            pat = pat.strip("/")
            if pat and (target.startswith(pat) or bucket == pat):
                return True
        return False

    def _should_cache(self, bucket: str, obj: str) -> bool:
        if self.cfg.after <= 0:
            return True
        key = f"{bucket}/{obj}"
        n = self._hit_counts.get(key, 0) + 1
        self._hit_counts[key] = n
        if n >= self.cfg.after:
            del self._hit_counts[key]
            return True
        return False

    # -- the cached read path -------------------------------------------------

    def get_object(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
        offset: int = 0,
        length: int = -1,
    ):
        opts = opts or GetObjectOptions()
        drive = self._drive(bucket, object_name)
        # Versioned reads and excluded prefixes bypass the cache entirely
        # (the reference caches only latest-version reads).
        if (
            drive is None
            or getattr(opts, "version_id", "") != ""
            or self._excluded(bucket, object_name)
        ):
            return self.backend.get_object(bucket, object_name, opts, offset, length)

        rng = f"{offset}-{length}" if (offset, length) != (0, -1) else ""
        cached = drive.lookup(bucket, object_name, rng) or (
            # A whole-object entry can serve any range.
            drive.lookup(bucket, object_name) if rng else None
        )

        # Validate against the backend when it answers; serve stale when the
        # whole backend is unreachable (disk-cache.go backend-down serving).
        try:
            info = self.backend.get_object_info(bucket, object_name, opts)
            backend_online = True
        except (errors.ObjectNotFound, errors.VersionNotFound):
            if drive is not None:
                drive.invalidate(bucket, object_name)
            raise
        except errors.StorageError:
            backend_online = False
            info = None

        if cached is not None:
            meta, data = cached
            if not backend_online or (info is not None and info.etag == meta["etag"]):
                self._hits += 1
                oi = ObjectInfo(
                    bucket=bucket,
                    name=object_name,
                    etag=meta["etag"],
                    version_id=meta.get("version_id", ""),
                    mod_time=meta["mod_time"],
                    size=info.size if info is not None else meta["size"],
                    content_type=meta.get("content_type", "application/octet-stream"),
                    user_defined=dict(meta.get("user_defined", {})),
                    internal=dict(meta.get("internal", {})),
                    actual_size=meta.get("actual_size"),
                )
                if meta.get("range", ""):
                    return oi, data
                if rng:
                    end = len(data) if length < 0 else min(offset + length, len(data))
                    return oi, data[offset:end]
                return oi, data
            drive.invalidate(bucket, object_name)  # stale entry

        self._misses += 1
        oi, data = self.backend.get_object(bucket, object_name, opts, offset, length)
        if self._should_cache(bucket, object_name):
            try:
                drive.save(bucket, object_name, oi, data, rng)
            except OSError:
                pass  # cache write failure never fails the read
        return oi, data

    # -- invalidating writes ---------------------------------------------------

    def _invalidate(self, bucket: str, object_name: str) -> None:
        d = self._drive(bucket, object_name)
        if d is not None:
            d.invalidate(bucket, object_name)

    def put_object(self, bucket, object_name, data, opts=None):
        self._invalidate(bucket, object_name)
        return self.backend.put_object(bucket, object_name, data, opts)

    def delete_object(self, bucket, object_name, opts=None):
        self._invalidate(bucket, object_name)
        return self.backend.delete_object(bucket, object_name, opts)

    def put_object_metadata(self, bucket, object_name, version_id="", updates=None, removes=None):
        self._invalidate(bucket, object_name)
        return self.backend.put_object_metadata(
            bucket, object_name, version_id, updates, removes
        )

    def complete_multipart_upload(self, bucket, object_name, upload_id, parts):
        self._invalidate(bucket, object_name)
        return self.backend.complete_multipart_upload(bucket, object_name, upload_id, parts)

    def delete_objects(self, bucket, items):
        for item in items:
            name = item[0] if isinstance(item, (tuple, list)) else item
            self._invalidate(bucket, name)
        return self.backend.delete_objects(bucket, items)

    def delete_bucket(self, bucket: str, force: bool = False):
        out = self.backend.delete_bucket(bucket, force)
        for d in self.drives:
            # Bucket-wide invalidation: entries are keyed by name hash, so a
            # full sweep is required; GC metadata carries the bucket name.
            for sub in list(os.listdir(d.root)):
                subp = os.path.join(d.root, sub)
                if not os.path.isdir(subp):
                    continue
                for ent in list(os.listdir(subp)):
                    ed = os.path.join(subp, ent)
                    try:
                        with open(os.path.join(ed, CACHE_META)) as f:
                            if json.load(f).get("bucket") == bucket:
                                shutil.rmtree(ed, ignore_errors=True)
                    except (OSError, ValueError):
                        continue
        return out

    # -- stats (cache metrics surface) ----------------------------------------

    def stats(self) -> dict:
        return {
            "hits": self._hits,
            "misses": self._misses,
            "drives": [
                {"path": d.root, "usage": d.usage(), "quota": self.cfg.quota_bytes}
                for d in self.drives
            ],
        }
