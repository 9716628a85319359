"""Bucket event notification: rules, targets, durable queue, live listen.

Role of the reference's internal/event (5.4K LoC: target/{webhook,...},
targetlist.go, queuestore.go) + cmd/event-notification.go: S3 events
(ObjectCreated:*, ObjectRemoved:*, ...) are matched against per-bucket
notification rules (prefix/suffix/event-name filters) and fanned out to
targets. Targets get an on-disk queue so broker outages don't lose events
(queuestore.go role). A live PubSub hub powers ListenBucketNotification.

Webhook is the first-class target (pure HTTP); the broker zoo (kafka, amqp,
mqtt, redis, ...) shares TargetQueue and plugs in behind the same Target
interface as thin senders when their client libraries are present.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
import uuid
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from .pubsub import PubSub
from .sanitizer import san_lock, san_rlock


@dataclass
class Event:
    name: str  # e.g. "s3:ObjectCreated:Put"
    bucket: str
    object_name: str
    etag: str = ""
    size: int = 0
    version_id: str = ""
    time: float = field(default_factory=time.time)
    region: str = ""
    user_identity: str = ""

    def to_record(self) -> dict:
        """S3 event record JSON shape."""
        return {
            "eventVersion": "2.0",
            "eventSource": "minio_tpu:s3",
            "awsRegion": self.region,
            "eventTime": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self.time)),
            "eventName": self.name.removeprefix("s3:"),
            "userIdentity": {"principalId": self.user_identity},
            "s3": {
                "s3SchemaVersion": "1.0",
                "bucket": {"name": self.bucket, "arn": f"arn:aws:s3:::{self.bucket}"},
                "object": {
                    "key": self.object_name,
                    "size": self.size,
                    "eTag": self.etag,
                    "versionId": self.version_id,
                },
            },
        }


@dataclass
class Rule:
    events: list[str]  # patterns like "s3:ObjectCreated:*"
    prefix: str = ""
    suffix: str = ""
    target_ids: list[str] = field(default_factory=list)

    def matches(self, event_name: str, object_name: str) -> bool:
        if not any(fnmatch.fnmatchcase(event_name, pat) for pat in self.events):
            return False
        if self.prefix and not object_name.startswith(self.prefix):
            return False
        if self.suffix and not object_name.endswith(self.suffix):
            return False
        return True


def parse_notification_xml(raw: str | bytes) -> list[Rule]:
    """Parse S3 NotificationConfiguration XML (QueueConfiguration etc.)."""
    if not raw:
        return []
    root = ET.fromstring(raw)
    rules = []
    for cfg in root:
        tag = cfg.tag.split("}")[-1]
        if tag not in ("QueueConfiguration", "TopicConfiguration", "CloudFunctionConfiguration"):
            continue
        events: list[str] = []
        prefix = suffix = ""
        targets: list[str] = []
        for el in cfg:
            t = el.tag.split("}")[-1]
            if t == "Event":
                events.append(el.text or "")
            elif t in ("Queue", "Topic", "CloudFunction"):
                targets.append((el.text or "").split(":")[-1])
            elif t == "Filter":
                for fr in el.iter():
                    if fr.tag.split("}")[-1] == "FilterRule":
                        kv = {c.tag.split("}")[-1]: (c.text or "") for c in fr}
                        if kv.get("Name", "").lower() == "prefix":
                            prefix = kv.get("Value", "")
                        elif kv.get("Name", "").lower() == "suffix":
                            suffix = kv.get("Value", "")
        rules.append(Rule(events=events, prefix=prefix, suffix=suffix, target_ids=targets))
    return rules


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------


class TargetQueue:
    """Durable per-target send queue with a disk spool
    (internal/event/target/queuestore.go role)."""

    def __init__(self, send, queue_dir: str = "", queue_limit: int = 100_000):
        self._send = send
        self.queue_dir = queue_dir
        self.queue_limit = queue_limit
        self._mem: list[dict] = []
        self._lock = san_lock("TargetQueue._lock")
        self._wake = threading.Event()
        self._stop = threading.Event()
        if queue_dir:
            os.makedirs(queue_dir, exist_ok=True)
            self._reload_spool()
            if self._mem:
                self._wake.set()  # drain recovered spool without the idle tick
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _reload_spool(self) -> None:
        for name in sorted(os.listdir(self.queue_dir)):
            path = os.path.join(self.queue_dir, name)
            try:
                with open(path) as f:
                    record = json.load(f)
            except (OSError, ValueError):
                continue
            if not isinstance(record, dict):
                continue  # stray/corrupt file; leave for operator inspection
            # Re-attach the spool path so the file is removed once sent
            # (without this, restart-recovered events leave their spool
            # files behind forever).
            record["__spool__"] = path
            self._mem.append(record)

    def put(self, record: dict) -> None:
        # Private copy: emit() hands the SAME dict to every target, and each
        # queue annotates its own spool path on it.
        record = dict(record)
        # Spool the record BEFORE taking the lock: disk I/O under _lock
        # would serialize every producer behind one slow drive. On a
        # full-queue drop the optimistically written file is unlinked.
        fn = ""
        if self.queue_dir:
            fn = os.path.join(self.queue_dir, f"{time.time_ns()}-{uuid.uuid4().hex}.json")
            try:
                with open(fn, "w") as f:
                    json.dump(record, f)
                record["__spool__"] = fn
            except OSError:
                fn = ""
        with self._lock:
            dropped = len(self._mem) >= self.queue_limit
            if not dropped:
                self._mem.append(record)
        if dropped:  # drop oldest-tolerant: refuse new when full
            if fn:
                try:
                    os.unlink(fn)
                except OSError:
                    pass
            return
        self._wake.set()

    def _loop(self) -> None:
        backoff = 0.1
        while not self._stop.is_set():
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._mem:
                        break
                    record = self._mem[0]
                try:
                    payload = {k: v for k, v in record.items() if k != "__spool__"}
                    self._send(payload)
                    with self._lock:
                        self._mem.pop(0)
                    spool = record.get("__spool__")
                    if spool:
                        try:
                            os.remove(spool)
                        except OSError:
                            pass
                    backoff = 0.1
                except Exception:  # noqa: BLE001 - broker down: retry later
                    if self._stop.wait(backoff):
                        return
                    backoff = min(backoff * 2, 10.0)
                    break

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        # The loop re-checks _stop right after its wake poll; bounded join so
        # a target mid-send (send timeout) cannot hang teardown.
        self._thread.join(5.0)

    def pending(self) -> int:
        with self._lock:
            return len(self._mem)


class WebhookEventTarget:
    def __init__(self, target_id: str, endpoint: str, queue_dir: str = "", queue_limit: int = 100_000):
        import requests

        self.id = target_id
        self.endpoint = endpoint
        self.session = requests.Session()
        self.queue = TargetQueue(self._post, queue_dir, queue_limit)

    def _post(self, record: dict) -> None:
        r = self.session.post(self.endpoint, json=record, timeout=5.0)
        r.raise_for_status()

    def send(self, record: dict) -> None:
        self.queue.put(record)

    def close(self) -> None:
        self.queue.close()


# ---------------------------------------------------------------------------
# Notifier
# ---------------------------------------------------------------------------


class EventNotifier:
    """Per-bucket rules + target registry + live listen hub
    (cmd/event-notification.go EventNotifier role)."""

    def __init__(self):
        self.targets: dict[str, WebhookEventTarget] = {}
        self.bucket_rules: dict[str, list[Rule]] = {}
        self.listen_hub = PubSub("listen")
        self._lock = san_rlock("EventNotifier._lock")

    def register_target(self, target) -> None:
        with self._lock:
            self.targets[target.id] = target

    def set_bucket_rules_from_xml(self, bucket: str, xml_raw: str | bytes) -> None:
        rules = parse_notification_xml(xml_raw)
        with self._lock:
            if rules:
                self.bucket_rules[bucket] = rules
            else:
                self.bucket_rules.pop(bucket, None)

    def emit(self, event: Event) -> None:
        record = {"EventName": event.name, "Key": f"{event.bucket}/{event.object_name}",
                  "Records": [event.to_record()]}
        if self.listen_hub.num_subscribers():
            self.listen_hub.publish(record)
        with self._lock:
            rules = list(self.bucket_rules.get(event.bucket, []))
            targets = dict(self.targets)
        for rule in rules:
            if not rule.matches(event.name, event.object_name):
                continue
            for tid in rule.target_ids or list(targets):
                t = targets.get(tid)
                if t is not None:
                    t.send(record)
