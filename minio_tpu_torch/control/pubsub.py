"""Zero-overhead pub/sub for tracing and live event streams.

Role of the reference's internal/pubsub (pubsub.go, 87 LoC): publishers check
num_subscribers() before building a message, so tracing costs nothing when
nobody watches (the pattern used at handler-utils.go:359,
xl-storage-disk-id-check.go:580, os-instrumented.go:63).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable
from .sanitizer import san_lock, san_rlock


class PubSub:
    def __init__(self, name: str = ""):
        self.name = name  # metrics label; "" = anonymous test hub
        self._subs: list[queue.Queue] = []
        self._lock = san_lock("PubSub._lock")
        # Messages dropped on full subscriber queues. A slow subscriber
        # never blocks publishers, but the loss must be observable: metrics
        # renders minio_tpu_pubsub_dropped_total{hub=...} and the stream
        # endpoints stamp the count into a response header
        # (api/streams.py), so a watcher with holes in its feed can tell.
        self.dropped = 0

    def num_subscribers(self) -> int:
        return len(self._subs)

    def publish(self, item: Any) -> None:
        with self._lock:
            subs = list(self._subs)
        lost = 0
        for q in subs:
            try:
                q.put_nowait(item)
            except queue.Full:
                lost += 1  # slow subscriber drops messages, never blocks publishers
        if lost:
            with self._lock:
                self.dropped += lost

    def subscribe(self, maxsize: int = 10_000) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=maxsize)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            try:
                self._subs.remove(q)
            except ValueError:
                pass


class TraceSys:
    """Process-wide trace hub: HTTP requests, storage calls, OS calls
    (admin `trace` feature, cmd/admin-handlers.go:1103)."""

    def __init__(self):
        self.hub = PubSub("trace")

    def enabled(self) -> bool:
        return self.hub.num_subscribers() > 0

    def publish(self, trace_type: str, **fields) -> None:
        if not self.enabled():
            return
        import time

        fields["type"] = trace_type
        fields["time"] = time.time()
        self.hub.publish(fields)

    def subscribe(self):
        return self.hub.subscribe()

    def unsubscribe(self, q):
        self.hub.unsubscribe(q)


GLOBAL_TRACE = TraceSys()
