"""Compact JWT verification for STS identity federation.

Supports what the reference's OIDC path needs (sts-handlers.go
AssumeRoleWithSSO; internal/config/identity/openid): RS256 against a JWKS
document and HS256 against a shared secret, with exp/nbf/aud validation.
Zero-egress stance: the JWKS is supplied via config (static document), not
fetched from an issuer URL.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import json
import time


class JWTError(Exception):
    pass


def _b64url_decode(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def _b64url_to_int(s: str) -> int:
    return int.from_bytes(_b64url_decode(s), "big")


def decode_unverified(token: str) -> tuple[dict, dict, bytes, bytes]:
    try:
        h, p, sig = token.split(".")
        header = json.loads(_b64url_decode(h))
        payload = json.loads(_b64url_decode(p))
        return header, payload, _b64url_decode(sig), f"{h}.{p}".encode()
    except (ValueError, TypeError) as e:
        raise JWTError(f"malformed token: {e}")


def _verify_rs256(signing_input: bytes, sig: bytes, n: int, e: int) -> bool:
    """Textbook RSASSA-PKCS1-v1_5 verification (public-key op only — no
    secrets, so no side-channel concerns): sig^e mod n must equal the padded
    DigestInfo for SHA-256."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n).to_bytes(k, "big")
    digest_info = (
        b"\x30\x31\x30\x0d\x06\x09\x60\x86\x48\x01\x65\x03\x04\x02\x01\x05\x00\x04\x20"
        + hashlib.sha256(signing_input).digest()
    )
    expected = b"\x00\x01" + b"\xff" * (k - len(digest_info) - 3) + b"\x00" + digest_info
    return hmac_mod.compare_digest(m, expected)


def verify(
    token: str,
    jwks: dict | None = None,
    hmac_secret: str = "",
    audience: str = "",
    now: float | None = None,
) -> dict:
    """Verify signature + time claims, return the payload. Raises JWTError."""
    header, payload, sig, signing_input = decode_unverified(token)
    alg = header.get("alg", "")

    if alg == "HS256":
        if not hmac_secret:
            raise JWTError("no HMAC secret configured")
        want = hmac_mod.new(hmac_secret.encode(), signing_input, hashlib.sha256).digest()
        if not hmac_mod.compare_digest(want, sig):
            raise JWTError("signature mismatch")
    elif alg == "RS256":
        if not jwks or not jwks.get("keys"):
            raise JWTError("no JWKS configured")
        kid = header.get("kid", "")
        candidates = [
            k
            for k in jwks["keys"]
            if k.get("kty") == "RSA" and (not kid or k.get("kid", "") == kid)
        ]
        if not candidates:
            raise JWTError(f"no RSA key matches kid {kid!r}")
        ok = any(
            _verify_rs256(
                signing_input, sig, _b64url_to_int(k["n"]), _b64url_to_int(k["e"])
            )
            for k in candidates
        )
        if not ok:
            raise JWTError("signature mismatch")
    else:
        raise JWTError(f"unsupported alg {alg!r}")

    t = time.time() if now is None else now

    def numeric(name):
        v = payload.get(name)
        if v is None:
            return None
        try:
            return float(v)
        except (TypeError, ValueError):
            raise JWTError(f"non-numeric {name} claim")

    exp = numeric("exp")
    if exp is not None and t > exp:
        raise JWTError("token expired")
    nbf = numeric("nbf")
    if nbf is not None and t < nbf:
        raise JWTError("token not yet valid")
    if audience:
        aud = payload.get("aud", payload.get("azp", ""))
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise JWTError("audience mismatch")
    return payload


# -- signing (test/tooling helper; the server only verifies) -----------------


def sign_hs256(payload: dict, secret: str, header_extra: dict | None = None) -> str:
    header = {"alg": "HS256", "typ": "JWT", **(header_extra or {})}

    def enc(obj) -> str:
        return base64.urlsafe_b64encode(json.dumps(obj).encode()).rstrip(b"=").decode()

    signing_input = f"{enc(header)}.{enc(payload)}"
    sig = hmac_mod.new(secret.encode(), signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + base64.urlsafe_b64encode(sig).rstrip(b"=").decode()
