"""Structured logging + per-request audit log.

Role of the reference's internal/logger (console/HTTP targets, audit.go,
reqinfo.go, logonce.go): JSON-structured server logs with pluggable targets,
an audit record for every API call, and once-per-error deduplication.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
import traceback
from typing import Any

from .pubsub import PubSub
from .sanitizer import san_lock, san_rlock


class LogTarget:
    def send(self, entry: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class ConsoleTarget(LogTarget):
    def __init__(self, stream=None, as_json: bool = False):
        self.stream = stream or sys.stderr
        self.as_json = as_json

    def send(self, entry: dict) -> None:
        if self.as_json:
            self.stream.write(json.dumps(entry) + "\n")
        else:
            lvl = entry.get("level", "INFO")
            self.stream.write(f"[{lvl}] {entry.get('message', '')}\n")
        self.stream.flush()


class WebhookTarget(LogTarget):
    """HTTP log/audit sink (internal/logger/target/http role).

    send() is called on the REQUEST path (Logger.audit runs inside the API
    handler), so it must never block on the network: entries land in a
    bounded queue and a dedicated sender thread posts them, with bounded
    retry and backoff -- the reference's logger/target/http store-and-
    forward queue. A full queue drops the entry and counts it (`dropped`,
    rendered as minio_tpu_audit_dropped_total); an entry that exhausts its
    retries counts as `failed`. close() flushes what it can inside a
    drain budget so shutdown loses as little as the sink allows.
    """

    def __init__(self, endpoint: str, timeout: float = 5.0,
                 queue_size: int = 1000, retries: int = 2,
                 retry_wait_s: float = 0.25):
        import requests

        self.endpoint = endpoint
        self.session = requests.Session()
        self.timeout = timeout
        self.retries = max(0, retries)
        self.retry_wait_s = retry_wait_s
        self._q: queue.Queue = queue.Queue(maxsize=max(1, queue_size))
        self._lock = san_lock("WebhookTarget._lock")
        self._stop = threading.Event()
        self.dropped = 0  # entries lost to a full queue (backpressure)
        self.failed = 0   # entries that exhausted their retries
        self.sent = 0
        self._thread = threading.Thread(
            target=self._run, name="log-webhook", daemon=True
        )
        self._thread.start()

    def send(self, entry: dict) -> None:
        """Enqueue only -- the request path never waits on the sink."""
        try:
            self._q.put_nowait(entry)
        except queue.Full:
            with self._lock:
                self.dropped += 1

    def _run(self) -> None:
        while True:
            try:
                entry = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return  # queue drained AND close() asked us out
                continue
            self._post(entry)

    def _post(self, entry: dict) -> None:
        for attempt in range(self.retries + 1):
            try:
                self.session.post(self.endpoint, json=entry, timeout=self.timeout)
                with self._lock:
                    self.sent += 1
                return
            except Exception:  # noqa: BLE001 - logging must never take down serving
                if attempt < self.retries and not self._stop.is_set():
                    # Linear backoff, interruptible so close() isn't held
                    # hostage by a dead endpoint.
                    self._stop.wait(self.retry_wait_s * (attempt + 1))
        with self._lock:
            self.failed += 1

    def close(self, drain_s: float = 5.0) -> None:
        """Flush-on-close: give the sender thread up to drain_s to empty
        the queue, then stop it regardless (counters say what was lost)."""
        self._stop.set()
        self._thread.join(timeout=max(0.0, drain_s))

    def stats(self) -> dict:
        with self._lock:
            return {"queued": self._q.qsize(), "sent": self.sent,
                    "dropped": self.dropped, "failed": self.failed}


class Logger:
    def __init__(self):
        self.targets: list[LogTarget] = [ConsoleTarget()]
        self.audit_targets: list[LogTarget] = []
        self.audit_hub = PubSub("audit")  # live `admin trace --call audit` taps
        self._once: set[str] = set()
        self._lock = san_lock("Logger._lock")

    def log(self, level: str, message: str, **fields: Any) -> None:
        entry = {"level": level, "message": message, "time": time.time(), **fields}
        for t in self.targets:
            t.send(entry)

    def info(self, message: str, **fields: Any) -> None:
        self.log("INFO", message, **fields)

    def error(self, message: str, exc: BaseException | None = None, **fields: Any) -> None:
        if exc is not None:
            fields["trace"] = "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__)
            )[-4000:]
        self.log("ERROR", message, **fields)

    def log_once(self, message: str, key: str | None = None, **fields: Any) -> None:
        """Deduplicated error logging (internal/logger/logonce.go role)."""
        k = key or message
        with self._lock:
            if k in self._once:
                return
            self._once.add(k)
        self.error(message, **fields)

    # -- audit (logger/audit.go role: one record per API call) ---------------

    def audit(
        self,
        api: str,
        bucket: str = "",
        object_name: str = "",
        status_code: int = 0,
        duration_ms: float = 0.0,
        access_key: str = "",
        remote: str = "",
        request_id: str = "",
        **extra: Any,
    ) -> None:
        if not self.audit_targets and self.audit_hub.num_subscribers() == 0:
            return
        entry = {
            "version": "1",
            "time": time.time(),
            "api": {"name": api, "bucket": bucket, "object": object_name,
                    "statusCode": status_code, "timeToResponseMs": duration_ms},
            "accessKey": access_key,
            "remotehost": remote,
            "requestID": request_id,
            **extra,
        }
        self.audit_hub.publish(entry)
        for t in self.audit_targets:
            t.send(entry)

    def close(self) -> None:
        """Flush-and-stop every buffering target (WebhookTarget queues):
        process shutdown (dist/node.py close_all) drains what it can."""
        for t in (*self.targets, *self.audit_targets):
            fn = getattr(t, "close", None)
            if fn is not None:
                fn()


GLOBAL_LOGGER = Logger()
