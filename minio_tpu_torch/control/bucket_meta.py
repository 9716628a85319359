"""Bucket metadata subsystem: per-bucket configs with an in-memory cache.

Role of the reference's BucketMetadataSys (cmd/bucket-metadata-sys.go:491 +
bucket-metadata.go): one durable record per bucket holding every sub-config
(versioning, policy, tagging, lifecycle, encryption, replication, quota,
notification rules), cached in memory, persisted through the object layer
under the system meta bucket so it inherits erasure durability.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

from ..object.erasure import META_BUCKET
from ..object.types import GetObjectOptions, PutObjectOptions
from ..utils import errors


@dataclass
class BucketMetadata:
    name: str
    created: float = field(default_factory=time.time)
    versioning: str = ""  # "", "Enabled", "Suspended"
    policy_json: str = ""
    tagging: dict[str, str] = field(default_factory=dict)
    lifecycle_xml: str = ""
    encryption_xml: str = ""
    replication_xml: str = ""
    object_lock_xml: str = ""
    cors_xml: str = ""
    notification_xml: str = ""
    quota: int = 0
    targets_json: str = ""  # replication remote targets (bucket-targets.go)

    def versioning_enabled(self) -> bool:
        return self.versioning == "Enabled"

    def versioning_suspended(self) -> bool:
        return self.versioning == "Suspended"

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BucketMetadata":
        d = json.loads(raw)
        known = {k: d[k] for k in cls.__dataclass_fields__ if k in d}
        return cls(**known)


class BucketMetadataSys:
    def __init__(self, layer):
        self.layer = layer
        self._cache: dict[str, BucketMetadata] = {}
        self._lock = threading.RLock()
        # Fired after every durable mutation (save/update/delete) with the
        # bucket name. The node wires this to the peer-invalidation
        # broadcast: this cache has NO TTL, so EVERY writer — the S3
        # handlers, site replication applying remote changes, the
        # replication target registry — must reach peers or they serve
        # stale policy/rules/targets indefinitely. Hooking the mutation
        # itself means no writer can forget.
        self.on_change = None

    def _path(self, bucket: str) -> str:
        return f"buckets/{bucket}/bucket-metadata.json"

    def get(self, bucket: str) -> BucketMetadata:
        with self._lock:
            if bucket in self._cache:
                return self._cache[bucket]
        try:
            _, raw = self.layer.pools[0].get_object(
                META_BUCKET, self._path(bucket), GetObjectOptions()
            )
            meta = BucketMetadata.from_bytes(raw)
        except (errors.ObjectNotFound, errors.BucketNotFound, errors.VersionNotFound,
                errors.FileNotFound):
            meta = BucketMetadata(name=bucket)  # genuinely no config yet
        # Quorum/read failures PROPAGATE uncached: caching a default-empty
        # record on a degraded read would serve no-policy/no-quota/no-rules
        # indefinitely (this cache has no TTL).
        with self._lock:
            self._cache[bucket] = meta
        return meta

    def save(self, meta: BucketMetadata) -> None:
        self.layer.pools[0].put_object(
            META_BUCKET, self._path(meta.name), meta.to_bytes(), PutObjectOptions()
        )
        with self._lock:
            self._cache[meta.name] = meta
        if self.on_change is not None:
            self.on_change(meta.name)

    def update(self, bucket: str, **fields) -> BucketMetadata:
        meta = self.get(bucket)
        for k, v in fields.items():
            setattr(meta, k, v)
        self.save(meta)
        return meta

    def delete(self, bucket: str) -> None:
        with self._lock:
            self._cache.pop(bucket, None)
        try:
            self.layer.pools[0].delete_object(META_BUCKET, self._path(bucket))
        except errors.ObjectError:
            pass
        if self.on_change is not None:
            self.on_change(bucket)

    def invalidate(self, bucket: str) -> None:
        with self._lock:
            self._cache.pop(bucket, None)
