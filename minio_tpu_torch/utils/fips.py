"""FIPS mode: restrict the SECURITY crypto surface to approved algorithms.

Role of the reference's FIPS build flavor (internal/fips, built with
boringcrypto): in FIPS deployments only approved primitives may serve
security functions. The reference selects this at BUILD time with a Go
toolchain tag; a Python build has one artifact, so this is a RUNTIME
switch (MINIO_TPU_FIPS=on) enforced at the policy point the flag owns:

  * Signature V2 auth is refused (HMAC-SHA1); SigV4 (HMAC-SHA256) stays.

Everything else already sits on approved primitives whose implementation
comes from the host OpenSSL (hashlib / the cryptography package) — under a
FIPS-provisioned OpenSSL those are the validated module, the same way the
reference swaps in boringcrypto: AES-256-GCM for SSE/KMS envelopes, SHA-256
for SigV4/content digests, HS256/RS256 for JWTs.

Deliberately NOT restricted, matching the reference's FIPS build: bitrot
checksums (HighwayHash) and the MD5 ETag. Both are integrity/wire-compat
checksums, not security controls — the reference ships HighwayHash bitrot
and MD5 ETags unchanged in its FIPS flavor.
"""

from __future__ import annotations

import os


def enabled() -> bool:
    return os.environ.get("MINIO_TPU_FIPS", "").lower() in ("1", "on", "true", "yes")
