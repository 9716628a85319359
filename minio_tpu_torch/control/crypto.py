"""Server-side encryption: DARE-style packaged AES-256-GCM + key sealing.

Role of the reference's cmd/encryption-v1.go + internal/crypto (+ minio/sio):
objects are encrypted in 64 KiB packages, each sealed with AES-256-GCM under
a per-object data key; the object key is itself sealed by either a KMS data
key (SSE-S3/SSE-KMS) or the client's supplied key (SSE-C). Sealed-key,
algorithm, and package metadata travel in internal object metadata
(x-internal-sse-*) that never leaves the server.

Package layout per 64 KiB chunk (DARE package analogue, encryption-v1.go:63):
    nonce (12) || ciphertext+tag (chunk+16)
"""

from __future__ import annotations

import base64
import hashlib
import secrets
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # gated: unencrypted paths must work without the lib
    AESGCM = None

from ..utils import errors
from .kms import KMS

PACKAGE_SIZE = 64 * 1024  # DARE package payload (encryption-v1.go:63-67)
OVERHEAD = 12 + 16  # nonce + GCM tag

# Internal metadata keys (never exposed to clients).
META_ALGO = "x-internal-sse"
META_SEALED_KEY = "x-internal-sse-sealed-key"
META_KMS_KEY_ID = "x-internal-sse-kms-key-id"
META_KMS_DATA_KEY = "x-internal-sse-kms-sealed-datakey"
META_ACTUAL_SIZE = "x-internal-actual-size"
META_SSEC_KEY_MD5 = "x-internal-ssec-key-md5"

ALGO_SSE_S3 = "SSE-S3"
ALGO_SSE_C = "SSE-C"


def _aead(key: bytes):
    if AESGCM is None:
        raise errors.StorageError("SSE unavailable: cryptography not installed")
    return AESGCM(key)


def encrypt_stream(data: bytes, object_key: bytes) -> bytes:
    """Package-encrypt a whole buffer with the per-object key."""
    aead = _aead(object_key)
    out = bytearray()
    for i, off in enumerate(range(0, len(data), PACKAGE_SIZE)):
        chunk = data[off : off + PACKAGE_SIZE]
        nonce = secrets.token_bytes(12)
        # Bind the package index so chunks can't be reordered.
        out += nonce + aead.encrypt(nonce, chunk, i.to_bytes(8, "big"))
    if not data:
        nonce = secrets.token_bytes(12)
        out += nonce + aead.encrypt(nonce, b"", (0).to_bytes(8, "big"))
    return bytes(out)


def decrypt_stream(blob: bytes, object_key: bytes) -> bytes:
    aead = _aead(object_key)
    out = bytearray()
    pos = 0
    i = 0
    package = PACKAGE_SIZE + OVERHEAD
    while pos < len(blob):
        frame = blob[pos : pos + package]
        nonce, ct = frame[:12], frame[12:]
        try:
            out += aead.decrypt(nonce, ct, i.to_bytes(8, "big"))
        except Exception:
            raise errors.FileCorrupt("SSE package authentication failed")
        pos += len(frame)
        i += 1
    return bytes(out)


def _seal_key(object_key: bytes, kek: bytes, context: bytes) -> bytes:
    nonce = secrets.token_bytes(12)
    return nonce + _aead(kek).encrypt(nonce, object_key, context)


def _unseal_key(sealed: bytes, kek: bytes, context: bytes) -> bytes:
    aead = _aead(kek)
    try:
        return aead.decrypt(sealed[:12], sealed[12:], context)
    except Exception:
        raise errors.PreconditionFailed(msg="SSE key unseal failed")


@dataclass
class SSEResult:
    data: bytes
    metadata: dict[str, str]


def sse_s3_encrypt(data: bytes, kms: KMS, bucket: str, object_name: str) -> SSEResult:
    """SSE-S3: object key sealed by a KMS data key."""
    dk = kms.generate_key(context=f"{bucket}/{object_name}")
    object_key = secrets.token_bytes(32)
    sealed = _seal_key(object_key, dk.plaintext, f"{bucket}/{object_name}".encode())
    meta = {
        META_ALGO: ALGO_SSE_S3,
        META_SEALED_KEY: base64.b64encode(sealed).decode(),
        META_KMS_KEY_ID: dk.key_id,
        META_KMS_DATA_KEY: base64.b64encode(dk.ciphertext).decode(),
        META_ACTUAL_SIZE: str(len(data)),
    }
    return SSEResult(encrypt_stream(data, object_key), meta)


def sse_s3_decrypt(blob: bytes, meta: dict[str, str], kms: KMS, bucket: str, object_name: str) -> bytes:
    dk_plain = kms.decrypt_key(
        meta[META_KMS_KEY_ID],
        base64.b64decode(meta[META_KMS_DATA_KEY]),
        context=f"{bucket}/{object_name}",
    )
    object_key = _unseal_key(
        base64.b64decode(meta[META_SEALED_KEY]), dk_plain, f"{bucket}/{object_name}".encode()
    )
    return decrypt_stream(blob, object_key)


def sse_c_encrypt(data: bytes, client_key: bytes, bucket: str, object_name: str) -> SSEResult:
    """SSE-C: object key sealed by the client-provided 32-byte key."""
    if len(client_key) != 32:
        raise errors.InvalidArgument(msg="SSE-C key must be 32 bytes")
    object_key = secrets.token_bytes(32)
    sealed = _seal_key(object_key, client_key, f"{bucket}/{object_name}".encode())
    meta = {
        META_ALGO: ALGO_SSE_C,
        META_SEALED_KEY: base64.b64encode(sealed).decode(),
        META_SSEC_KEY_MD5: hashlib.md5(client_key).hexdigest(),
        META_ACTUAL_SIZE: str(len(data)),
    }
    return SSEResult(encrypt_stream(data, object_key), meta)


def sse_c_decrypt(blob: bytes, meta: dict[str, str], client_key: bytes, bucket: str, object_name: str) -> bytes:
    if hashlib.md5(client_key).hexdigest() != meta.get(META_SSEC_KEY_MD5, ""):
        raise errors.PreconditionFailed(msg="SSE-C key mismatch")
    object_key = _unseal_key(
        base64.b64decode(meta[META_SEALED_KEY]), client_key, f"{bucket}/{object_name}".encode()
    )
    return decrypt_stream(blob, object_key)


def is_encrypted(meta: dict[str, str]) -> str:
    return meta.get(META_ALGO, "")


def seal_secret(kms, context: str, secret: str) -> str:
    """Seal a small config secret (remote-target / tier credentials) with a
    KMS data key for at-rest storage. Format: sealed:<keyid>:<b64 dk>:<b64 blob>.
    The reference KMS-encrypts such config (cmd/config-encrypted.go role)."""
    if kms is None:
        return secret
    import base64

    dk = kms.generate_key(context=context)
    blob = encrypt_stream(secret.encode(), dk.plaintext)
    return "sealed:" + ":".join(
        [dk.key_id, base64.b64encode(dk.ciphertext).decode(), base64.b64encode(blob).decode()]
    )


def unseal_secret(kms, context: str, stored: str) -> str:
    if not stored.startswith("sealed:"):
        return stored
    if kms is None:
        raise errors.StorageError("sealed secret but no KMS configured")
    import base64

    key_id, ct, blob = stored[len("sealed:"):].split(":")
    dk = kms.decrypt_key(key_id, base64.b64decode(ct), context=context)
    return decrypt_stream(base64.b64decode(blob), dk).decode()
