"""AWS Signature V2 (signed + presigned) — legacy auth support.

Role of the reference's cmd/signature-v2.go: ``doesSignV2Match`` /
``doesPresignV2SignatureMatch``. String-to-sign::

    Method\nContent-MD5\nContent-Type\nDate\nCanonicalizedAmzHeaders CanonicalizedResource

Signature = base64(hmac-sha1(secret, string-to-sign)).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import urllib.parse

from .errors import S3Error

# Sub-resources included in the canonical resource, in sorted order
# (resourceList, cmd/signature-v2.go).
_SUBRESOURCES = {
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type", "response-expires",
    "select", "select-type", "tagging", "torrent", "uploadId", "uploads",
    "versionId", "versioning", "versions", "website",
}


def _canonical_amz_headers(headers: dict[str, str]) -> str:
    amz = {}
    for k, v in headers.items():
        lk = k.lower().strip()
        if lk.startswith("x-amz-"):
            amz.setdefault(lk, []).append(v.strip())
    return "".join(f"{k}:{','.join(vs)}\n" for k, vs in sorted(amz.items()))


def _canonical_resource(path: str, query: list[tuple[str, str]]) -> str:
    sub = sorted((k, v) for k, v in query if k in _SUBRESOURCES)
    if not sub:
        return path
    parts = []
    for k, v in sub:
        parts.append(f"{k}={v}" if v else k)
    return path + "?" + "&".join(parts)


def string_to_sign_v2(
    method: str,
    path: str,
    query: list[tuple[str, str]],
    headers: dict[str, str],
    date_value: str,
) -> str:
    h = {k.lower(): v for k, v in headers.items()}
    return "\n".join(
        [
            method.upper(),
            h.get("content-md5", ""),
            h.get("content-type", ""),
            date_value,
        ]
    ) + "\n" + _canonical_amz_headers(h) + _canonical_resource(path, query)


def _sig(secret: str, sts: str) -> str:
    return base64.b64encode(hmac.new(secret.encode(), sts.encode(), hashlib.sha1).digest()).decode()


def sign_request_v2(
    access_key: str,
    secret_key: str,
    method: str,
    path: str,
    query: list[tuple[str, str]],
    headers: dict[str, str],
) -> dict[str, str]:
    """Client side: add Date + Authorization V2 headers."""
    headers = {k.lower(): v for k, v in headers.items()}
    if "date" not in headers and "x-amz-date" not in headers:
        headers["date"] = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%a, %d %b %Y %H:%M:%S GMT"
        )
    date_value = "" if "x-amz-date" in headers else headers.get("date", "")
    sts = string_to_sign_v2(method, path, query, headers, date_value)
    headers["authorization"] = f"AWS {access_key}:{_sig(secret_key, sts)}"
    return headers


def presign_url_v2(
    access_key: str,
    secret_key: str,
    method: str,
    path: str,
    host: str,
    expires_in: int = 3600,
    query: list[tuple[str, str]] | None = None,
) -> str:
    expires = str(int(datetime.datetime.now(datetime.timezone.utc).timestamp()) + expires_in)
    q = list(query or [])
    sts = "\n".join([method.upper(), "", "", expires]) + "\n" + _canonical_resource(path, q)
    sig = _sig(secret_key, sts)
    qs = urllib.parse.urlencode(
        q + [("AWSAccessKeyId", access_key), ("Expires", expires), ("Signature", sig)]
    )
    return f"http://{host}{path}?{qs}"


def _reject_if_fips() -> None:
    # V2 signatures are HMAC-SHA1; FIPS deployments must refuse them at
    # the door rather than verify-then-serve. Checked per verify call so
    # the runtime switch holds even if a verifier instance is ever cached.
    from ..utils import fips

    if fips.enabled():
        raise S3Error(
            "InvalidRequest", "Signature Version 2 is disabled in FIPS mode"
        )


class SigV2Verifier:
    def __init__(self, lookup, check_expiry: bool = True):
        """lookup: access_key -> object with .secret_key, or None."""
        self.lookup = lookup
        self.check_expiry = check_expiry

    def _secret(self, access_key: str) -> str:
        c = self.lookup(access_key)
        if c is None:
            raise S3Error("InvalidAccessKeyId")
        return c.secret_key

    def verify_signed(
        self,
        method: str,
        path: str,
        query: list[tuple[str, str]],
        headers: dict[str, str],
    ) -> str:
        _reject_if_fips()
        h = {k.lower(): v for k, v in headers.items()}
        authz = h.get("authorization", "")
        if not authz.startswith("AWS ") or ":" not in authz:
            raise S3Error("AuthorizationHeaderMalformed")
        access_key, _, given = authz[4:].partition(":")
        secret = self._secret(access_key)
        date_value = "" if "x-amz-date" in h else h.get("date", "")
        sts = string_to_sign_v2(method, path, query, headers, date_value)
        if not hmac.compare_digest(_sig(secret, sts), given):
            raise S3Error("SignatureDoesNotMatch")
        return access_key

    def verify_presigned(
        self,
        method: str,
        path: str,
        query: list[tuple[str, str]],
    ) -> str:
        _reject_if_fips()
        qd = dict(query)
        try:
            access_key = qd["AWSAccessKeyId"]
            expires = qd["Expires"]
            given = qd["Signature"]
        except KeyError:
            raise S3Error("AuthorizationHeaderMalformed")
        if self.check_expiry:
            now = datetime.datetime.now(datetime.timezone.utc).timestamp()
            if now > int(expires):
                raise S3Error("ExpiredPresignRequest")
        secret = self._secret(access_key)
        rest = [(k, v) for k, v in query if k not in ("AWSAccessKeyId", "Expires", "Signature")]
        sts = "\n".join([method.upper(), "", "", expires]) + "\n" + _canonical_resource(path, rest)
        if not hmac.compare_digest(_sig(secret, sts), given):
            raise S3Error("SignatureDoesNotMatch")
        return access_key


def is_v2_signed(headers: dict) -> bool:
    a = {k.lower(): v for k, v in headers.items()}.get("authorization", "")
    return a.startswith("AWS ") and not a.startswith("AWS4-")


def is_v2_presigned(query: dict) -> bool:
    return "AWSAccessKeyId" in query and "Signature" in query and "Expires" in query
