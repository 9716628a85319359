"""Data usage accounting: per-prefix tree, persisted snapshots.

Role of the reference's cmd/data-usage-cache.go (dataUsageEntry :49,
dataUsageCache :225 -- a per-prefix tree persisted per disk and merged) +
data-usage.go: the scanner folds every object into this tree; the admin API
and metrics read the latest snapshot. The update-tracker bloom filter's job
(data-update-tracker.go) is played by a simple dirty-bucket set feeding
incremental scans.

A copy of the JAX package's control/usage.py: `to_bytes` writes the same
JSON, so a port node and a JAX node read each other's
`scanner/data-usage.json`.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from .sanitizer import san_lock, san_rlock


@dataclass
class UsageEntry:
    objects: int = 0
    versions: int = 0
    size: int = 0
    children: dict[str, "UsageEntry"] = field(default_factory=dict)

    def add(self, size: int, versions: int = 1) -> None:
        self.objects += 1
        self.versions += versions
        self.size += size

    def to_dict(self) -> dict:
        d = {"o": self.objects, "v": self.versions, "s": self.size}
        if self.children:
            d["c"] = {k: v.to_dict() for k, v in self.children.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "UsageEntry":
        e = cls(objects=d.get("o", 0), versions=d.get("v", 0), size=d.get("s", 0))
        e.children = {k: cls.from_dict(v) for k, v in d.get("c", {}).items()}
        return e


class DataUsageCache:
    """Root = buckets; children = first path segments (bounded depth)."""

    MAX_DEPTH = 3

    def __init__(self):
        self.root: dict[str, UsageEntry] = {}
        self.last_update = 0.0
        self._lock = san_lock("DataUsageCache._lock")

    def record(self, bucket: str, object_name: str, size: int, versions: int = 1) -> None:
        with self._lock:
            e = self.root.setdefault(bucket, UsageEntry())
            e.add(size, versions)
            parts = object_name.split("/")[: self.MAX_DEPTH - 1]
            node = e
            for seg in parts[:-1] if len(parts) > 1 else []:
                node = node.children.setdefault(seg + "/", UsageEntry())
                node.add(size, versions)

    def reset(self) -> None:
        with self._lock:
            self.root = {}

    def finish(self) -> None:
        with self._lock:
            self.last_update = time.time()

    def bucket_usage(self, bucket: str) -> UsageEntry:
        with self._lock:
            return self.root.get(bucket, UsageEntry())

    def summary(self) -> dict:
        """DataUsageInfo shape (admin API + metrics)."""
        with self._lock:
            return {
                "lastUpdate": self.last_update,
                "objectsCount": sum(e.objects for e in self.root.values()),
                "versionsCount": sum(e.versions for e in self.root.values()),
                "objectsTotalSize": sum(e.size for e in self.root.values()),
                "bucketsCount": len(self.root),
                "bucketsUsage": {
                    b: {"objectsCount": e.objects, "size": e.size, "versionsCount": e.versions}
                    for b, e in self.root.items()
                },
            }

    def to_bytes(self) -> bytes:
        with self._lock:
            return json.dumps(
                {
                    "lastUpdate": self.last_update,
                    "root": {k: v.to_dict() for k, v in self.root.items()},
                }
            ).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DataUsageCache":
        c = cls()
        d = json.loads(raw)
        c.last_update = d.get("lastUpdate", 0.0)
        c.root = {k: UsageEntry.from_dict(v) for k, v in d.get("root", {}).items()}
        return c
