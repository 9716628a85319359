"""Config subsystem: KV registry, env overrides, durable storage.

Role of the reference's internal/config (config.go:187 RegisterDefaultKVS,
subsystem constants :49-185) + cmd/config-current.go: configuration is a set
of subsystems each holding k=v pairs, defaults registered at import, every
key overridable by MINIO_TPU_<SUBSYS>_<KEY> env vars, the merged document
persisted through the object layer so it survives restarts and propagates via
peer reload. Keys are marked dynamic (apply live) or static (need restart).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ..utils import errors
from .sanitizer import san_rlock

ENV_PREFIX = "MINIO_TPU"

# Subsystem names (subset of internal/config/config.go:49-185 that this
# framework implements; grows with the feature surface).
SUBSYS_API = "api"
SUBSYS_STORAGE_CLASS = "storage_class"
SUBSYS_COMPRESSION = "compression"
SUBSYS_HEAL = "heal"
SUBSYS_SCANNER = "scanner"
SUBSYS_LOGGER = "logger_webhook"
SUBSYS_AUDIT = "audit_webhook"
SUBSYS_NOTIFY_WEBHOOK = "notify_webhook"
SUBSYS_REGION = "region"
SUBSYS_ENCODER = "encoder"  # device batching runtime knobs (this framework's own)
SUBSYS_IDENTITY_OPENID = "identity_openid"
SUBSYS_IDENTITY_LDAP = "identity_ldap"
SUBSYS_IDENTITY_TLS = "identity_tls"


@dataclass
class KV:
    key: str
    value: str
    dynamic: bool = False


class ConfigSys:
    """Registry + current values + persistence."""

    def __init__(self, store=None):
        self._defaults: dict[str, dict[str, KV]] = {}
        self._current: dict[str, dict[str, str]] = {}
        self._lock = san_rlock("ConfigSys._lock")
        self.store = store  # object-layer-backed blob store (ConfigStore)
        self._register_defaults()

    # -- registry ------------------------------------------------------------

    def register(self, subsys: str, kvs: list[KV]) -> None:
        with self._lock:
            self._defaults.setdefault(subsys, {})
            for kv in kvs:
                self._defaults[subsys][kv.key] = kv

    def _register_defaults(self) -> None:
        self.register(
            SUBSYS_API,
            [
                KV("requests_max", "0", dynamic=True),
                KV("cors_allow_origin", "*", dynamic=True),
                KV("delete_cleanup_interval", "5m", dynamic=True),
            ],
        )
        self.register(
            SUBSYS_IDENTITY_OPENID,
            [
                # Static JWKS document / shared HMAC secret (zero-egress: no
                # issuer discovery; internal/config/identity/openid role).
                KV("jwks", "", dynamic=True),
                KV("hmac_secret", "", dynamic=True),
                KV("claim_name", "policy", dynamic=True),
                KV("client_id", "", dynamic=True),
            ],
        )
        self.register(
            SUBSYS_IDENTITY_LDAP,
            [
                # Lookup-bind flow keys (internal/config/identity/ldap names).
                KV("server_addr", "", dynamic=False),
                KV("lookup_bind_dn", "", dynamic=True),
                KV("lookup_bind_password", "", dynamic=True),
                KV("user_dn_search_base_dn", "", dynamic=True),
                KV("user_dn_search_filter", "(uid=%s)", dynamic=True),
                KV("group_search_base_dn", "", dynamic=True),
                KV("group_search_filter", "", dynamic=True),
                KV("tls", "off", dynamic=False),
                KV("tls_skip_verify", "off", dynamic=False),
            ],
        )
        self.register(
            SUBSYS_IDENTITY_TLS,
            [KV("enable", "off", dynamic=True)],
        )
        self.register(
            SUBSYS_STORAGE_CLASS,
            [KV("standard", "", dynamic=True), KV("rrs", "EC:2", dynamic=True)],
        )
        self.register(
            SUBSYS_COMPRESSION,
            [
                KV("enable", "off", dynamic=True),
                KV("extensions", ".txt,.log,.csv,.json,.tar,.xml,.bin", dynamic=True),
                KV("mime_types", "text/*,application/json,application/xml", dynamic=True),
            ],
        )
        self.register(
            SUBSYS_HEAL,
            [
                KV("bitrotscan", "off", dynamic=True),
                KV("max_sleep", "1s", dynamic=True),
                KV("max_io", "100", dynamic=True),
            ],
        )
        self.register(
            SUBSYS_SCANNER,
            [KV("delay", "10", dynamic=True), KV("max_wait", "15s", dynamic=True),
             KV("cycle", "1m", dynamic=True)],
        )
        self.register(SUBSYS_REGION, [KV("name", "us-east-1")])
        self.register(
            SUBSYS_LOGGER,
            [KV("enable", "off", dynamic=True), KV("endpoint", "", dynamic=True)],
        )
        self.register(
            SUBSYS_AUDIT,
            [KV("enable", "off", dynamic=True), KV("endpoint", "", dynamic=True)],
        )
        self.register(
            SUBSYS_NOTIFY_WEBHOOK,
            [
                KV("enable", "off", dynamic=True),
                KV("endpoint", "", dynamic=True),
                KV("queue_dir", "", dynamic=True),
                KV("queue_limit", "100000", dynamic=True),
            ],
        )
        # Broker notification targets (internal/event/target zoo). Native
        # protocol targets; kafka/amqp/mysql/postgresql additionally need
        # their optional client libraries at enable time.
        self.register(
            "notify_redis",
            [
                KV("enable", "off"),
                KV("address", "127.0.0.1:6379"),
                KV("key", "minio_events"),
                KV("format", "access"),
                KV("password", ""),
            ],
        )
        self.register(
            "notify_nats",
            [KV("enable", "off"), KV("address", "127.0.0.1:4222"), KV("subject", "minio_events")],
        )
        self.register(
            "notify_mqtt",
            [KV("enable", "off"), KV("broker", "127.0.0.1:1883"), KV("topic", "minio_events")],
        )
        self.register(
            "notify_nsq",
            [KV("enable", "off"), KV("nsqd_address", "127.0.0.1:4151"), KV("topic", "minio_events")],
        )
        self.register(
            "notify_elasticsearch",
            [
                KV("enable", "off"),
                KV("url", "http://127.0.0.1:9200"),
                KV("index", "minio_events"),
                KV("format", "namespace"),
            ],
        )
        self.register(
            "notify_kafka",
            [KV("enable", "off"), KV("brokers", "127.0.0.1:9092"), KV("topic", "minio_events")],
        )
        self.register(
            "notify_amqp",
            [KV("enable", "off"), KV("url", ""), KV("exchange", ""), KV("routing_key", "")],
        )
        self.register("notify_mysql", [KV("enable", "off"), KV("dsn_string", ""), KV("table", "minio_events")])
        self.register("notify_postgres", [KV("enable", "off"), KV("connection_string", ""), KV("table", "minio_events")])
        self.register(
            SUBSYS_ENCODER,
            [
                KV("batch_timeout_us", "500", dynamic=True),
                KV("max_batch", "32", dynamic=True),
                KV("device", "auto", dynamic=False),
            ],
        )

    # -- lookups (env > stored > default; env handling per
    #    serverHandleEnvVars, cmd/common-main.go) ----------------------------

    def get(self, subsys: str, key: str) -> str:
        env = f"{ENV_PREFIX}_{subsys.upper()}_{key.upper()}"
        if env in os.environ:
            return os.environ[env]
        with self._lock:
            cur = self._current.get(subsys, {})
            if key in cur:
                return cur[key]
            d = self._defaults.get(subsys, {})
            if key in d:
                return d[key].value
        raise errors.InvalidArgument(msg=f"unknown config key {subsys}.{key}")

    def get_bool(self, subsys: str, key: str) -> bool:
        return self.get(subsys, key).lower() in ("on", "true", "1", "yes", "enabled")

    def get_int(self, subsys: str, key: str) -> int:
        return int(self.get(subsys, key))

    def set(self, subsys: str, key: str, value: str) -> bool:
        """Returns True if the key is dynamic (applies live)."""
        with self._lock:
            d = self._defaults.get(subsys)
            if d is None or key not in d:
                raise errors.InvalidArgument(msg=f"unknown config key {subsys}.{key}")
            self._current.setdefault(subsys, {})[key] = value
            dynamic = d[key].dynamic
        self._persist()
        return dynamic

    def unset(self, subsys: str, key: str) -> None:
        with self._lock:
            self._current.get(subsys, {}).pop(key, None)
        self._persist()

    def dump(self) -> dict[str, dict[str, str]]:
        """Effective config: defaults overlaid with stored values."""
        with self._lock:
            out: dict[str, dict[str, str]] = {}
            for subsys, kvs in self._defaults.items():
                out[subsys] = {k: kv.value for k, kv in kvs.items()}
                out[subsys].update(self._current.get(subsys, {}))
            return out

    # -- persistence ---------------------------------------------------------

    def _persist(self) -> None:
        if self.store is None:
            return
        with self._lock:
            doc = json.dumps(self._current).encode()
        self.store.put("config/config.json", doc)

    def load(self) -> None:
        if self.store is None:
            return
        raw = self.store.get("config/config.json")
        if raw:
            with self._lock:
                self._current = json.loads(raw)


class ConfigStore:
    """Small durable blobs under the system meta bucket (the reference keeps
    config in .minio.sys/config through the object layer for erasure
    durability; same here)."""

    def __init__(self, layer):
        self.layer = layer

    def put(self, path: str, data: bytes) -> None:
        from ..object.erasure import META_BUCKET
        from ..object.types import PutObjectOptions

        self.layer.pools[0].put_object(META_BUCKET, path, data, PutObjectOptions())

    def get(self, path: str) -> bytes | None:
        from ..object.erasure import META_BUCKET
        from ..object.types import GetObjectOptions

        try:
            _, data = self.layer.pools[0].get_object(META_BUCKET, path, GetObjectOptions())
            return data
        except (errors.ObjectNotFound, errors.BucketNotFound, errors.VersionNotFound):
            return None
        # Quorum/read failures PROPAGATE: "couldn't read the config" must
        # never be conflated with "no config exists" — a caller that treats
        # a degraded-quorum None as an empty store will later persist an
        # empty snapshot over the real one.

    def delete(self, path: str) -> None:
        from ..object.erasure import META_BUCKET

        try:
            self.layer.pools[0].delete_object(META_BUCKET, path)
        except errors.ObjectError:
            pass
