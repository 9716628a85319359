"""Metacache: persistent, resumable listing caches.

The reference never re-walks drives for every ListObjects page: listPath
(cmd/metacache-server-pool.go:59) looks up / creates a per-(bucket, prefix)
metacache, streamMetadataParts (cmd/metacache-set.go:349) serves pages out of
persisted cache blocks with resume cursors, and WalkDir (metacache-walk.go:62)
only runs when the cache is absent or stale. This module is the store's
equivalent: one merged walk fills an in-memory sorted entry list; subsequent
pages bisect into it; bucket writes invalidate; a msgpack image is persisted
under the meta bucket so a restarted process can serve the first page without
a cold walk.

Coherence model (same tradeoff the reference makes): caches may serve a
listing a few seconds stale. Local writes invalidate immediately via the
write-generation counter; remote writers are bounded by the TTL.
"""

from __future__ import annotations

import bisect
import hashlib
import logging
import struct
import threading
import time

import msgpack

_log = logging.getLogger(__name__)

META_BUCKET = ".minio.sys"

# Persisted image layout: 8-byte big-endian unix-time header, then the
# msgpack body. The header lets a reader reject a stale image without
# unpacking a potentially multi-MB entry list.
_HDR = struct.Struct(">d")

# How long a filled cache may serve pages before a fresh walk is forced.
DEFAULT_TTL_S = 15.0
# Entry cap: a listing bigger than this is served straight from the walk
# (memory bound; the reference bounds cache block count similarly).
MAX_ENTRIES = 500_000


class _Cache:
    """One filled listing: sorted names + raw xl.meta images."""

    __slots__ = ("names", "raws", "filled_at", "generation")

    def __init__(self, names: list[str], raws: list[bytes], generation: int):
        self.names = names
        self.raws = raws
        self.filled_at = time.monotonic()
        self.generation = generation


def cache_path(bucket: str, prefix: str) -> str:
    """On-disk cache image path under the meta bucket (persistence parity
    with putMetacacheObject, cmd/metacache-set.go write-back blocks)."""
    h = hashlib.sha256(f"{bucket}\0{prefix}".encode()).hexdigest()[:16]
    return f"buckets/{bucket}/.metacache/{h}"


class MetacacheManager:
    """Per-namespace listing cache manager.

    `walk` is the expensive merged-drive walk: fn(bucket, prefix) -> iterator
    of (name, raw). `persist`/`load` write/read a cache image under the meta
    bucket (best effort; None disables persistence).
    """

    def __init__(self, walk, persist=None, load=None, ttl_s: float = DEFAULT_TTL_S):
        self._walk = walk
        self._persist = persist
        self._load = load
        self.ttl_s = ttl_s
        self._caches: dict[tuple[str, str], _Cache] = {}
        self._generations: dict[str, int] = {}
        # Persisted images are only worth consulting once per (bucket,
        # prefix) per process: after that, either the in-memory cache or a
        # walk is strictly fresher.
        self._cold_checked: set[tuple[str, str]] = set()
        self._lock = threading.Lock()
        # Log keys already warned about: each failure kind is logged once.
        self._logged: set[str] = set()
        # Instrumentation: tests pin that paging does not re-walk per page.
        self.walks = 0
        self.hits = 0

    # -- invalidation ------------------------------------------------------

    def generation(self, bucket: str) -> int:
        with self._lock:
            return self._generations.get(bucket, 0)

    def invalidate(self, bucket: str) -> None:
        """Called on every namespace write to the bucket."""
        with self._lock:
            self._generations[bucket] = self._generations.get(bucket, 0) + 1
            stale = [k for k in self._caches if k[0] == bucket]
            for k in stale:
                del self._caches[k]

    # -- lookup ------------------------------------------------------------

    def _valid(self, c: _Cache, bucket: str) -> bool:
        return (
            c.generation == self.generation(bucket)
            and time.monotonic() - c.filled_at < self.ttl_s
        )

    def entries_from(self, bucket: str, prefix: str, marker: str):
        """Iterate (name, raw) with name > marker, from cache when valid.

        Fills the cache on miss (one walk), persists the image, and serves
        the page by bisect -- the resume-cursor discipline of
        cmd/metacache-set.go:349.
        """
        key = (bucket, prefix)
        with self._lock:
            cache = self._caches.get(key)
            check_cold = key not in self._cold_checked
            self._cold_checked.add(key)
        if cache is not None and self._valid(cache, bucket):
            self.hits += 1
            return self._page(cache, marker)
        if check_cold:
            cache = self._load_persisted(bucket, prefix)
            if cache is not None:
                with self._lock:
                    self._caches[key] = cache
                self.hits += 1
                return self._page(cache, marker)
        return self._fill(key, marker)

    def _page(self, cache: _Cache, marker: str):
        start = bisect.bisect_right(cache.names, marker) if marker else 0
        names, raws = cache.names, cache.raws
        for i in range(start, len(names)):
            yield names[i], raws[i]

    def _fill(self, key: tuple[str, str], marker: str):
        """Run the walk to completion, cache + persist, then serve the page.

        The walk was already fully materialized per List call before this
        module existed (the merged-quorum resolve needs every drive's view),
        so paying it once and then paging by cursor strictly dominates.
        """
        bucket, prefix = key
        generation = self.generation(bucket)
        self.walks += 1
        names: list[str] = []
        raws: list[bytes] = []
        for name, raw in self._walk(bucket, prefix):
            names.append(name)
            raws.append(raw)
        cache = _Cache(names, raws, generation)
        if len(names) <= MAX_ENTRIES:
            with self._lock:
                self._caches[key] = cache
            if self._persist is not None:
                try:
                    body = msgpack.packb(
                        {"v": 1, "bucket": bucket, "prefix": prefix,
                         "entries": list(zip(names, raws))},
                        use_bin_type=True,
                    )
                    self._persist(
                        cache_path(bucket, prefix), _HDR.pack(time.time()) + body
                    )
                except Exception as e:  # noqa: BLE001 - persistence is best effort
                    self._log_once("metacache-persist", f"metacache persist failed for {bucket}/{prefix}: {e}")
        return self._page(cache, marker)

    def _log_once(self, key: str, msg: str) -> None:
        with self._lock:
            if key in self._logged:
                return
            self._logged.add(key)
        _log.warning(msg)

    def _load_persisted(self, bucket: str, prefix: str) -> _Cache | None:
        """Cold-start reuse of a persisted image, bounded by wall-clock TTL.

        Only consulted once per key per process, before the first walk (a
        fresh process has no in-memory cache); the write-generation guard
        cannot span restarts, so the TTL alone bounds staleness here. The
        image's remaining TTL is its ORIGINAL one: filled_at is backdated by
        the image's age so a 14s-old image serves for 1s more, not 15s.
        """
        if self._load is None:
            return None
        with self._lock:
            if self._generations.get(bucket, 0) != 0:
                return None  # bucket already written in this process: walk
        try:
            blob = self._load(cache_path(bucket, prefix))
            age = time.time() - _HDR.unpack(blob[: _HDR.size])[0]
            if not 0 <= age <= self.ttl_s:
                return None
            doc = msgpack.unpackb(blob[_HDR.size :], raw=False)
            if doc.get("v") != 1:
                return None
            names = [n for n, _ in doc["entries"]]
            raws = [r for _, r in doc["entries"]]
            cache = _Cache(names, raws, self.generation(bucket))
            cache.filled_at -= age
            return cache
        except Exception:  # noqa: BLE001
            return None
