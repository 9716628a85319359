"""etcd v3 store backend: IAM/config persistence outside the object layer.

Role of the reference's etcd integration (cmd/iam-etcd-store.go:578 +
internal/config/etcd): in gateway and federated deployments there is no
erasure-backed meta bucket to persist IAM into, so identities live in an
etcd cluster shared by every node. This client speaks etcd's v3 JSON
gateway (grpc-gateway: POST /v3/kv/put, /v3/kv/range, /v3/kv/deleterange
with base64-encoded keys/values) over one persistent keep-alive connection
— the same zero-dependency stdlib-http pattern as the KES client.

It implements the store interface IAMSys/ConfigSys already use
(get/put/delete of small blobs), so `MINIO_TPU_ETCD_ENDPOINT` simply swaps
where IAM durability lives; the sealed-blob encryption layered above it in
IAMSys applies unchanged (secrets in etcd stay sealed by the root
credential, as the reference encrypts its etcd IAM payloads).
"""

from __future__ import annotations

import base64
import json
import threading

from ..utils import errors
from .sanitizer import san_lock, san_rlock

PREFIX = "minio_tpu/"  # namespacing inside a shared etcd keyspace


class EtcdError(errors.StorageError):
    pass


class EtcdClient:
    """Minimal etcd v3 JSON-gateway client (kv put/range/deleterange)."""

    def __init__(self, endpoint: str, timeout: float = 5.0, api_prefix: str = "/v3"):
        from urllib.parse import urlparse

        u = urlparse(endpoint)
        if u.scheme not in ("http", "https") or not u.netloc:
            raise errors.InvalidArgument(msg=f"bad etcd endpoint {endpoint!r}")
        self._scheme = u.scheme
        self._netloc = u.netloc
        self._timeout = timeout
        self._api = api_prefix
        self._conn = None
        self._lock = san_lock("EtcdClient._lock")

    def _open(self):
        import http.client
        import ssl

        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._netloc, timeout=self._timeout,
                context=ssl.create_default_context(),
            )
        return http.client.HTTPConnection(self._netloc, timeout=self._timeout)

    def _call(self, path: str, body: dict) -> dict:
        import http.client

        payload = json.dumps(body).encode()
        with self._lock:
            last: Exception | None = None
            for _ in (0, 1):  # one reopen+retry on a stale keep-alive socket
                if self._conn is None:
                    self._conn = self._open()
                try:
                    self._conn.request(
                        "POST", self._api + path, body=payload,
                        headers={"Content-Type": "application/json"},
                    )
                    resp = self._conn.getresponse()
                    data = resp.read()
                    break
                except (OSError, http.client.HTTPException) as e:
                    try:
                        self._conn.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._conn = None
                    last = e
            else:
                raise EtcdError(f"etcd unreachable: {last}") from last
        if resp.status >= 300:
            raise EtcdError(f"etcd {path} -> {resp.status}: {data[:200]!r}")
        try:
            return json.loads(data) if data else {}
        except ValueError as e:
            raise EtcdError(f"etcd: bad response body: {e}") from e

    @staticmethod
    def _b64(v: bytes) -> str:
        return base64.b64encode(v).decode()

    def put(self, key: bytes, value: bytes) -> None:
        self._call("/kv/put", {"key": self._b64(key), "value": self._b64(value)})

    def get(self, key: bytes) -> bytes | None:
        r = self._call("/kv/range", {"key": self._b64(key)})
        kvs = r.get("kvs") or []
        if not kvs:
            return None
        return base64.b64decode(kvs[0].get("value", ""))

    def delete(self, key: bytes) -> None:
        self._call("/kv/deleterange", {"key": self._b64(key)})

    def status(self) -> dict:
        try:
            r = self._call("/maintenance/status", {})
            return {"online": True, **{k: r[k] for k in ("version",) if k in r}}
        except EtcdError:
            return {"online": False}


class EtcdStore:
    """The ConfigStore-shaped interface (get/put/delete of path-keyed
    blobs) over etcd — what IAMSys.store / ConfigSys.store accept."""

    def __init__(self, client: EtcdClient, prefix: str = PREFIX):
        self.client = client
        self.prefix = prefix

    def _key(self, path: str) -> bytes:
        return (self.prefix + path).encode()

    def put(self, path: str, data: bytes) -> None:
        self.client.put(self._key(path), data)

    def get(self, path: str) -> bytes | None:
        return self.client.get(self._key(path))

    def delete(self, path: str) -> None:
        self.client.delete(self._key(path))


def etcd_store_from_env() -> EtcdStore | None:
    """MINIO_TPU_ETCD_ENDPOINT=http://host:2379 -> IAM persists in etcd
    (the reference's IAM backend whenever etcd is configured, iam.go)."""
    import os

    ep = os.environ.get("MINIO_TPU_ETCD_ENDPOINT", "")
    if not ep:
        return None
    return EtcdStore(
        EtcdClient(ep),
        prefix=os.environ.get("MINIO_TPU_ETCD_PREFIX", PREFIX),
    )
