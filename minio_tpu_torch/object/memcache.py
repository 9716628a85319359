"""Coherent node-local in-memory hot-object cache (the read tier's L1).

Role: ROADMAP item 3's million-user read shape -- zipfian GETs of
mostly-small objects -- served from process memory instead of paying quorum
metadata reads plus shard IO per request. Stacked ABOVE the optional disk
CacheObjectLayer (dist/node.py), so the hierarchy is memory -> cache SSD ->
erasure set.

Coherence is two-layered, mirroring the reference's disk cache discipline
(cmd/disk-cache.go) tightened for memory speed:

  * Write-path invalidation: every mutating op through this layer drops the
    local entries and fans the invalidation to every peer (the same
    NotificationSys channel bucket metadata rides) BEFORE the ack returns,
    so a reader hitting any node after a completed PUT never sees the old
    bytes from cache.
  * ETag validation: every hit revalidates against the backend's
    get_object_info (a metadata quorum read -- no shard IO, no decode).
    A mismatch drops the entry and falls through to a miss. Backend down
    serves the (last-validated) entry stale, like the disk cache does.

Hot misses are singleflighted per (bucket, object, version, window): one
leader performs the backend read + fill while followers wait on its event
and then serve from the fresh entry -- a hot-set stampede costs one
backend read, not N.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

from ..control import tracing
from ..control.perf import GLOBAL_PERF
from ..control.sanitizer import san_lock
from ..utils import errors
from .types import GetObjectOptions, ObjectInfo

# Streaming hits hand out views over the cached bytes in response-sized
# slices (one aiohttp write per slice; matches the erasure block size).
_HIT_CHUNK = 1 << 20


class MemCacheConfig:
    """Sizing + policy knobs (all env-driven; MTPU_MEMCACHE_MB=0 disables)."""

    def __init__(
        self,
        limit_bytes: int,
        max_entry_bytes: int | None = None,
        validate: bool = True,
    ):
        self.limit_bytes = limit_bytes
        # One entry may not monopolize the tier: default cap is a quarter of
        # the budget, at most 64 MiB.
        if max_entry_bytes is None:
            max_entry_bytes = min(64 << 20, max(limit_bytes // 4, 1))
        self.max_entry_bytes = max_entry_bytes
        self.validate = validate

    @classmethod
    def from_env(cls) -> "MemCacheConfig | None":
        mb = int(os.environ.get("MTPU_MEMCACHE_MB", "0") or "0")
        if mb <= 0:
            return None
        max_mb = os.environ.get("MTPU_MEMCACHE_OBJ_MAX_MB", "")
        return cls(
            limit_bytes=mb << 20,
            max_entry_bytes=(int(max_mb) << 20) if max_mb else None,
            validate=os.environ.get("MTPU_MEMCACHE_VALIDATE", "1") != "0",
        )


class _Entry:
    __slots__ = ("oi", "data", "filled_at")

    def __init__(self, oi: ObjectInfo, data: bytes):
        self.oi = oi
        self.data = data
        self.filled_at = time.monotonic()


class MemObjectCache:
    """Bounded-memory LRU of cache entries, keyed
    (bucket, object, version, window) with a (bucket, object) reverse index
    for O(entries-of-object) invalidation. Pure store: no backend calls, no
    IO under the lock -- peer invalidation handlers touch this directly."""

    def __init__(self, cfg: MemCacheConfig):
        self.cfg = cfg
        self._lock = san_lock("MemObjectCache._lock")
        self._lru: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._by_object: dict[tuple[str, str], set[tuple]] = {}
        self._bytes = 0
        # Counters (the metrics/report surface).
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0
        self.invalidations = 0
        self.singleflight_waits = 0

    # -- store ----------------------------------------------------------------

    def get(self, key: tuple) -> _Entry | None:
        with self._lock:
            ent = self._lru.get(key)
            if ent is not None:
                self._lru.move_to_end(key)
            return ent

    def put(self, key: tuple, oi: ObjectInfo, data: bytes) -> bool:
        size = len(data)
        if size > self.cfg.max_entry_bytes or size > self.cfg.limit_bytes:
            return False
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= len(old.data)
            self._lru[key] = _Entry(oi, data)
            self._by_object.setdefault((key[0], key[1]), set()).add(key)
            self._bytes += size
            self.fills += 1
            while self._bytes > self.cfg.limit_bytes and self._lru:
                evicted_key, ev = self._lru.popitem(last=False)
                self._bytes -= len(ev.data)
                self.evictions += 1
                self._unindex_locked(evicted_key)
        return True

    def _unindex_locked(self, key: tuple) -> None:
        keys = self._by_object.get((key[0], key[1]))
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_object[(key[0], key[1])]

    def drop(self, key: tuple) -> None:
        """Remove one stale entry (failed ETag validation)."""
        with self._lock:
            ent = self._lru.pop(key, None)
            if ent is not None:
                self._bytes -= len(ent.data)
                self._unindex_locked(key)

    def invalidate_object(self, bucket: str, object_name: str) -> int:
        """Drop every entry (all versions/windows) of one object."""
        with self._lock:
            keys = self._by_object.pop((bucket, object_name), None)
            if not keys:
                return 0
            n = 0
            for key in keys:
                ent = self._lru.pop(key, None)
                if ent is not None:
                    self._bytes -= len(ent.data)
                    n += 1
            self.invalidations += n
            return n

    def invalidate_bucket(self, bucket: str) -> int:
        with self._lock:
            objs = [bo for bo in self._by_object if bo[0] == bucket]
        n = 0
        for _, obj in objs:
            n += self.invalidate_object(bucket, obj)
        return n

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "limit_bytes": self.cfg.limit_bytes,
                "bytes": self._bytes,
                "entries": len(self._lru),
                "hits": self.hits,
                "misses": self.misses,
                "hit_ratio": round(self.hits / lookups, 4) if lookups else 0.0,
                "fills": self.fills,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "singleflight_waits": self.singleflight_waits,
            }


class MemCacheObjectLayer:
    """Transparent ObjectLayer wrapper serving hot reads from a
    MemObjectCache (the CacheObjectLayer interposition idiom, one tier up).

    `on_invalidate(bucket, object)` -- wired by dist/node.py to the peer
    fanout -- runs after every local mutation and BEFORE the ack, so remote
    memcaches are coherent by the time the client's write returns."""

    def __init__(
        self,
        backend,
        store: MemObjectCache,
        on_invalidate=None,
    ):
        self.backend = backend
        self.store = store
        self.on_invalidate = on_invalidate
        self._fl_lock = san_lock("MemCacheObjectLayer._fl_lock")
        self._flights: dict[tuple, threading.Event] = {}

    # Everything not overridden passes straight through to the backend.
    def __getattr__(self, name):
        return getattr(self.backend, name)

    # -- key/window shape -----------------------------------------------------

    def _window(self, offset: int, length: int) -> tuple | None:
        """Cacheable window for a read: () = whole object; (offset, length)
        = an exact hot range window; None = uncacheable shape."""
        if offset == 0 and length < 0:
            return ()
        if offset >= 0 and 0 < length <= self.store.cfg.max_entry_bytes:
            return (offset, length)
        return None

    # -- the cached read path -------------------------------------------------

    def get_object_info(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
    ):
        """Hot-path metadata: with per-hit validation off, a cached
        whole-object entry's ObjectInfo is authoritative (write-path
        invalidation drops it before any mutation acks), so HEAD and the
        GET handler's pre-stream probe skip the metadata quorum read.
        With validation on, cached metadata is exactly what must be
        re-checked -- always ask the backend."""
        if not self.store.cfg.validate:
            opts = opts or GetObjectOptions()
            version = getattr(opts, "version_id", "") or ""
            ent = self.store.get((bucket, object_name, version, ()))
            if ent is not None:
                return ent.oi
        return self.backend.get_object_info(bucket, object_name, opts)

    def get_object(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
        offset: int = 0,
        length: int = -1,
    ):
        oi, stream = self.get_object_stream(bucket, object_name, opts, offset, length)
        buf = bytearray()
        for c in stream:
            buf += c  # mtpulint: disable=hot-path-copy -- buffered convenience; the stream path serves views
        return oi, bytes(buf)  # mtpulint: disable=hot-path-copy -- buffered convenience; the stream path serves views

    def get_object_stream(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
        offset: int = 0,
        length: int = -1,
    ):
        opts = opts or GetObjectOptions()
        window = self._window(offset, length)
        if window is None:
            return self._backend_stream(bucket, object_name, opts, offset, length)
        version = getattr(opts, "version_id", "") or ""
        key = (bucket, object_name, version, window)

        t0 = time.perf_counter()
        c0 = time.thread_time()
        served = self._serve_hit(key, opts, offset, length)
        if served is not None:
            # Stage mark outside a span: hits are served on whatever thread
            # asked; the ledger bucket is the always-on attribution.
            GLOBAL_PERF.ledger.record(
                "object", "cache-hit", time.perf_counter() - t0,
                time.thread_time() - c0,
            )
            cur = tracing.current()
            if cur is not None:
                cur.set(memcache="hit")
            return served

        self.store.misses += 1
        return self._fill_or_follow(key, bucket, object_name, opts, offset, length)

    def _serve_hit(self, key, opts, offset: int, length: int):
        """Validated cache hit -> (oi, chunks iterator), else None."""
        ent = self.store.get(key)
        whole = None
        if ent is None and key[3] != ():
            # A whole-object entry serves any in-bounds window.
            whole = self.store.get((key[0], key[1], key[2], ()))
            if whole is None:
                return None
            ent = whole
        elif ent is None:
            return None

        if self.store.cfg.validate:
            try:
                info = self.backend.get_object_info(
                    key[0], key[1], GetObjectOptions(version_id=key[2])
                )
            except (errors.ObjectNotFound, errors.VersionNotFound):
                self.store.invalidate_object(key[0], key[1])
                raise
            except errors.StorageError:
                info = None  # backend down: serve stale (disk-cache discipline)
            if info is not None and info.etag != ent.oi.etag:
                self.store.drop(key if whole is None else (key[0], key[1], key[2], ()))
                return None

        self.store.hits += 1
        data = ent.data
        if whole is not None or key[3] == ():
            end = len(data) if length < 0 else min(offset + length, len(data))
            lo, hi = offset, max(end, offset)
        else:
            lo, hi = 0, len(data)
        mv = memoryview(data)

        def chunks():
            for off in range(lo, hi, _HIT_CHUNK):
                yield mv[off : min(off + _HIT_CHUNK, hi)]

        return ent.oi, chunks()

    def _backend_stream(self, bucket, object_name, opts, offset, length):
        fn = getattr(self.backend, "get_object_stream", None)
        if fn is not None:
            return fn(bucket, object_name, opts, offset, length)
        oi, data = self.backend.get_object(bucket, object_name, opts, offset, length)
        return oi, iter((data,))

    def _fill_or_follow(self, key, bucket, object_name, opts, offset, length):
        """Singleflight miss path: one leader reads + fills; followers wait
        on the leader's event and serve the fresh entry."""
        with self._fl_lock:
            evt = self._flights.get(key)
            leader = evt is None
            if leader:
                evt = threading.Event()
                self._flights[key] = evt
        if not leader:
            self.store.singleflight_waits += 1
            evt.wait(timeout=30.0)
            served = self._serve_hit(key, opts, offset, length)
            if served is not None:
                return served
            # Leader failed or the object was uncacheable: read it ourselves.
            return self._backend_stream(bucket, object_name, opts, offset, length)

        try:
            t0 = time.perf_counter()
            c0 = time.thread_time()
            try:
                oi = self.backend.get_object_info(bucket, object_name, opts)
            except errors.StorageError:
                return self._backend_stream(bucket, object_name, opts, offset, length)
            want = length if key[3] != () else oi.size
            if want > self.store.cfg.max_entry_bytes:
                # Too big for the tier: stream through uncached.
                return self._backend_stream(bucket, object_name, opts, offset, length)
            oi, data = self.backend.get_object(bucket, object_name, opts, offset, length)
            self.store.put(key, oi, data)
            GLOBAL_PERF.ledger.record(
                "object", "cache-fill", time.perf_counter() - t0,
                time.thread_time() - c0,
            )
            mv = memoryview(data)

            def chunks():
                for off in range(0, len(mv), _HIT_CHUNK):
                    yield mv[off : off + _HIT_CHUNK]

            return oi, chunks()
        finally:
            with self._fl_lock:
                self._flights.pop(key, None)
            evt.set()

    # -- invalidating writes --------------------------------------------------

    def _invalidate(self, bucket: str, object_name: str) -> None:
        """Local drop + peer fanout, synchronously, before the caller's ack."""
        self.store.invalidate_object(bucket, object_name)
        if self.on_invalidate is not None:
            self.on_invalidate(bucket, object_name)

    def put_object(self, bucket, object_name, data, opts=None):
        out = self.backend.put_object(bucket, object_name, data, opts)
        self._invalidate(bucket, object_name)
        return out

    def delete_object(self, bucket, object_name, opts=None):
        out = self.backend.delete_object(bucket, object_name, opts)
        self._invalidate(bucket, object_name)
        return out

    def put_object_metadata(self, bucket, object_name, version_id="", updates=None, removes=None):
        out = self.backend.put_object_metadata(
            bucket, object_name, version_id, updates, removes
        )
        self._invalidate(bucket, object_name)
        return out

    def complete_multipart_upload(self, bucket, object_name, upload_id, parts):
        out = self.backend.complete_multipart_upload(
            bucket, object_name, upload_id, parts
        )
        self._invalidate(bucket, object_name)
        return out

    def delete_objects(self, bucket, items):
        out = self.backend.delete_objects(bucket, items)
        for item in items:
            name = item[0] if isinstance(item, (tuple, list)) else item
            self._invalidate(bucket, name)
        return out

    def delete_bucket(self, bucket: str, force: bool = False):
        out = self.backend.delete_bucket(bucket, force)
        self.store.invalidate_bucket(bucket)
        if self.on_invalidate is not None:
            self.on_invalidate(bucket, "")
        return out

    def stats(self) -> dict:
        return self.store.stats()
