"""KMS: key management for server-side encryption.

Role of the reference's internal/kms (kms.go KMS interface :29, single static
key, KES client kes.go:54): generate data keys wrapped by a named master key,
and unwrap them on reads. The static single-key backend is the default (as in
the reference's MINIO_KMS_SECRET_KEY); an external KES-style service slots in
behind the same interface.
"""

from __future__ import annotations

import base64
import os
import secrets
import threading
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # gated: a node without SSE must still boot
    AESGCM = None

from ..utils import errors
from .sanitizer import san_lock, san_rlock


@dataclass
class DataKey:
    key_id: str
    plaintext: bytes  # 32 bytes
    ciphertext: bytes  # sealed by the master key


class KMS:
    def generate_key(self, key_id: str = "", context: str = "") -> DataKey:  # pragma: no cover
        raise NotImplementedError

    def decrypt_key(self, key_id: str, ciphertext: bytes, context: str = "") -> bytes:  # pragma: no cover
        raise NotImplementedError

    def stat(self) -> dict:  # pragma: no cover
        raise NotImplementedError


class StaticKeyKMS(KMS):
    """Single master key (MINIO_TPU_KMS_SECRET_KEY=<name>:<base64-32-bytes>)."""

    def __init__(self, name: str = "default-key", master: bytes | None = None):
        self.name = name
        self.master = master or secrets.token_bytes(32)

    @classmethod
    def from_env(cls) -> "StaticKeyKMS | None":
        raw = os.environ.get("MINIO_TPU_KMS_SECRET_KEY", "")
        if not raw or ":" not in raw:
            return None
        name, b64 = raw.split(":", 1)
        key = base64.b64decode(b64)
        if len(key) != 32:
            raise errors.InvalidArgument(msg="KMS master key must be 32 bytes")
        return cls(name, key)

    def generate_key(self, key_id: str = "", context: str = "") -> DataKey:
        if AESGCM is None:
            raise errors.StorageError("SSE unavailable: cryptography not installed")
        key_id = key_id or self.name
        if key_id != self.name:
            raise errors.InvalidArgument(msg=f"unknown KMS key {key_id}")
        plaintext = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        sealed = nonce + AESGCM(self.master).encrypt(nonce, plaintext, context.encode())
        return DataKey(key_id=key_id, plaintext=plaintext, ciphertext=sealed)

    def decrypt_key(self, key_id: str, ciphertext: bytes, context: str = "") -> bytes:
        if AESGCM is None:
            raise errors.StorageError("SSE unavailable: cryptography not installed")
        if key_id != self.name:
            raise errors.InvalidArgument(msg=f"unknown KMS key {key_id}")
        nonce, ct = ciphertext[:12], ciphertext[12:]
        try:
            return AESGCM(self.master).decrypt(nonce, ct, context.encode())
        except Exception:
            raise errors.FileCorrupt("KMS unseal failed")

    def stat(self) -> dict:
        return {"name": "static-key", "default_key": self.name, "online": True}


class KESClient(KMS):
    """Network KMS client speaking the KES HTTP API.

    Role of the reference's KES client (internal/kms/kes.go:54,
    github.com/minio/kes-go): data-key generate/decrypt are delegated to an
    external key service so the master key never touches this process.
    Endpoints (KES API v1): POST /v1/key/generate/<name>,
    POST /v1/key/decrypt/<name>, GET /v1/status. Auth is a bearer API key
    (KES's non-mTLS mode); stdlib http.client keeps it zero-dependency like
    the event brokers.

    Decrypted data keys are LRU-cached: a hot GET stream re-unwraps the
    same sealed key per request, and the reference's client caches exactly
    this (kes-go Client.Decrypt cache).
    """

    def __init__(
        self,
        endpoint: str,
        default_key: str = "default-key",
        api_key: str = "",
        timeout: float = 5.0,
        cache_size: int = 1024,
    ):
        from urllib.parse import urlparse

        u = urlparse(endpoint)
        if u.scheme not in ("http", "https") or not u.netloc:
            raise errors.InvalidArgument(msg=f"bad KES endpoint {endpoint!r}")
        self._scheme = u.scheme
        self._netloc = u.netloc
        self.default_key = default_key
        self._api_key = api_key
        self._timeout = timeout
        self._cache: "dict[tuple[str, bytes, str], bytes]" = {}
        self._cache_size = cache_size
        self._lock = san_lock("KESClient._lock")
        # Small pool of persistent keep-alive connections. The lock guards
        # only checkout/checkin, never the network round-trip, so concurrent
        # SSE-KMS requests don't convoy behind one socket.
        self._pool: list = []
        self._pool_cap = 4
        self._conn_lock = san_lock("KESClient._conn_lock")

    @classmethod
    def from_env(cls) -> "KESClient | None":
        ep = os.environ.get("MINIO_TPU_KMS_KES_ENDPOINT", "")
        if not ep:
            return None
        return cls(
            ep,
            default_key=os.environ.get("MINIO_TPU_KMS_KES_KEY_NAME", "default-key"),
            api_key=os.environ.get("MINIO_TPU_KMS_KES_API_KEY", ""),
        )

    def _open(self):
        import http.client
        import ssl

        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._netloc, timeout=self._timeout,
                context=ssl.create_default_context(),
            )
        return http.client.HTTPConnection(self._netloc, timeout=self._timeout)

    def _request(self, method: str, path: str, body: dict | None = None) -> dict:
        import http.client
        import json as json_mod

        headers = {"Content-Type": "application/json"}
        if self._api_key:
            headers["Authorization"] = f"Bearer {self._api_key}"
        payload_out = json_mod.dumps(body).encode() if body is not None else None
        # Persistent keep-alive connections: generate_key sits on every
        # encrypted PUT, and a fresh TCP+TLS handshake per upload would
        # dominate the call. A stale/broken connection gets one reopen+retry.
        last_err: Exception | None = None
        for attempt in (0, 1):
            with self._conn_lock:
                conn = self._pool.pop() if self._pool else None
            if conn is None:
                conn = self._open()
            try:
                conn.request(method, path, body=payload_out, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                last_err = e
                continue
            # Healthy connection goes back for the next caller; beyond the
            # cap it closes (a burst must not pin sockets forever).
            with self._conn_lock:
                if len(self._pool) < self._pool_cap:
                    self._pool.append(conn)
                    conn = None
            if conn is not None:
                conn.close()
            break
        else:
            raise errors.StorageError(f"KES unreachable: {last_err}") from last_err
        if resp.status == 404:
            raise errors.InvalidArgument(msg=f"KES: unknown key ({path})")
        if resp.status in (401, 403):
            raise errors.FileAccessDenied("KES: not authorized")
        if resp.status >= 300:
            raise errors.StorageError(f"KES {resp.status}: {data[:200]!r}")
        try:
            return json_mod.loads(data) if data else {}
        except ValueError as e:
            raise errors.StorageError(f"KES: bad response body: {e}") from e

    def _cache_put(self, ck, plaintext: bytes) -> None:
        with self._lock:
            if ck not in self._cache and len(self._cache) >= self._cache_size:
                # evict the least-recently-used quarter (dict order is
                # recency order: hits re-insert at the back)
                for k in list(self._cache)[: max(1, self._cache_size // 4)]:
                    del self._cache[k]
            self._cache[ck] = plaintext

    def _cache_get(self, ck) -> bytes | None:
        with self._lock:
            v = self._cache.pop(ck, None)
            if v is not None:
                self._cache[ck] = v  # move-to-back = mark recently used
            return v

    @staticmethod
    def _key_path(op: str, key_id: str) -> str:
        from urllib.parse import quote

        # Admin-supplied key names must not rewrite the request path.
        return f"/v1/key/{op}/{quote(key_id, safe='')}"

    def generate_key(self, key_id: str = "", context: str = "") -> DataKey:
        key_id = key_id or self.default_key
        r = self._request(
            "POST", self._key_path("generate", key_id),
            {"context": base64.b64encode(context.encode()).decode()},
        )
        plaintext = base64.b64decode(r["plaintext"])
        ciphertext = base64.b64decode(r["ciphertext"])
        self._cache_put((key_id, ciphertext, context), plaintext)
        return DataKey(key_id=key_id, plaintext=plaintext, ciphertext=ciphertext)

    def decrypt_key(self, key_id: str, ciphertext: bytes, context: str = "") -> bytes:
        ck = (key_id, ciphertext, context)
        hit = self._cache_get(ck)
        if hit is not None:
            return hit
        r = self._request(
            "POST", self._key_path("decrypt", key_id),
            {
                "ciphertext": base64.b64encode(ciphertext).decode(),
                "context": base64.b64encode(context.encode()).decode(),
            },
        )
        plaintext = base64.b64decode(r["plaintext"])
        self._cache_put(ck, plaintext)
        return plaintext

    def stat(self) -> dict:
        try:
            r = self._request("GET", "/v1/status")
            return {
                "name": "kes",
                "endpoint": f"{self._scheme}://{self._netloc}",
                "default_key": self.default_key,
                "online": True,
                **{k: v for k, v in r.items() if k in ("version", "uptime")},
            }
        except errors.StorageError:
            return {
                "name": "kes",
                "endpoint": f"{self._scheme}://{self._netloc}",
                "default_key": self.default_key,
                "online": False,
            }


def kms_from_env() -> KMS | None:
    """Boot-time KMS selection: a configured KES endpoint wins over the
    static key (matching the reference, where KES is the production mode
    and MINIO_KMS_SECRET_KEY the dev fallback)."""
    return KESClient.from_env() or StaticKeyKMS.from_env()
