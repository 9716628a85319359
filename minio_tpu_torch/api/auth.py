"""AWS Signature V4 authentication (signing + verification).

Role of the reference's signature-v4.go / signature-v4-parser.go /
auth-handler.go: verify header-signed and presigned requests, and produce
signatures for the test client and internal clients. Streaming per-chunk
signatures (streaming-signature-v4.go) are handled in api/streaming.py.

Auth types recognized (getRequestAuthType equivalent):
  * signed (Authorization: AWS4-HMAC-SHA256 ...)
  * presigned (?X-Amz-Algorithm=AWS4-HMAC-SHA256...)
  * anonymous (no credentials)
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass

from .errors import S3Error

SIGN_V4_ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
MAX_SKEW_SECONDS = 15 * 60


@dataclass
class Credentials:
    access_key: str
    secret_key: str


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "" if encode_slash else "/"
    return urllib.parse.quote(s, safe=safe + "-_.~")


def canonical_query(params: list[tuple[str, str]], skip: set[str] = frozenset()) -> str:
    pairs = sorted(
        (_uri_encode(k), _uri_encode(v)) for k, v in params if k not in skip
    )
    return "&".join(f"{k}={v}" for k, v in pairs)


def canonical_request(
    method: str,
    path: str,
    query: list[tuple[str, str]],
    headers: dict[str, str],
    signed_headers: list[str],
    payload_hash: str,
    skip_query: set[str] = frozenset(),
) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers
    )
    return "\n".join(
        [
            method.upper(),
            _uri_encode(path, encode_slash=False),
            canonical_query(query, skip_query),
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(timestamp: str, scope: str, canon_req: str) -> str:
    return "\n".join(
        [SIGN_V4_ALGORITHM, timestamp, scope, hashlib.sha256(canon_req.encode()).hexdigest()]
    )


def sign_request(
    creds: Credentials,
    method: str,
    path: str,
    query: list[tuple[str, str]],
    headers: dict[str, str],
    payload: bytes | None,
    region: str = "us-east-1",
    timestamp: datetime.datetime | None = None,
    unsigned_payload: bool = False,
    payload_hash: str | None = None,
) -> dict[str, str]:
    """Produce the headers for a signed request (test client / internal RPC).

    Returns the full header dict including Authorization. ``payload_hash``
    overrides the computed hash (e.g. STREAMING-AWS4-HMAC-SHA256-PAYLOAD for
    aws-chunked uploads).
    """
    t = timestamp or datetime.datetime.now(datetime.timezone.utc)
    amz_date = t.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    headers = {k.lower(): v for k, v in headers.items()}
    headers["x-amz-date"] = amz_date
    if payload_hash is None:
        if unsigned_payload or payload is None:
            payload_hash = UNSIGNED_PAYLOAD
        else:
            payload_hash = hashlib.sha256(payload).hexdigest()
    headers["x-amz-content-sha256"] = payload_hash
    signed = sorted(set(headers) | {"host"})
    scope = f"{date}/{region}/s3/aws4_request"
    creq = canonical_request(method, path, query, headers, signed, payload_hash)
    sts = string_to_sign(amz_date, scope, creq)
    sig = hmac.new(signing_key(creds.secret_key, date, region), sts.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"{SIGN_V4_ALGORITHM} Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"
    )
    return headers


@dataclass
class ParsedAuth:
    access_key: str
    date: str
    region: str
    service: str
    signed_headers: list[str]
    signature: str


def parse_authorization(header: str) -> ParsedAuth:
    if not header.startswith(SIGN_V4_ALGORITHM):
        raise S3Error("AuthorizationHeaderMalformed")
    rest = header[len(SIGN_V4_ALGORITHM) :].strip()
    fields: dict[str, str] = {}
    for part in rest.split(","):
        part = part.strip()
        if "=" not in part:
            raise S3Error("AuthorizationHeaderMalformed")
        k, v = part.split("=", 1)
        fields[k.strip()] = v.strip()
    try:
        cred = fields["Credential"].split("/")
        access_key = "/".join(cred[:-4])
        date, region, service, terminal = cred[-4:]
        if terminal != "aws4_request":
            raise S3Error("AuthorizationHeaderMalformed")
        return ParsedAuth(
            access_key=access_key,
            date=date,
            region=region,
            service=service,
            signed_headers=fields["SignedHeaders"].split(";"),
            signature=fields["Signature"],
        )
    except (KeyError, ValueError):
        raise S3Error("AuthorizationHeaderMalformed")


class SigV4Verifier:
    """Verifies V4 signed and presigned requests against a credential lookup."""

    def __init__(self, lookup, region: str = "us-east-1", check_skew: bool = True):
        """lookup: access_key -> Credentials | None."""
        self.lookup = lookup
        self.region = region
        self.check_skew = check_skew

    def _creds(self, access_key: str) -> Credentials:
        c = self.lookup(access_key)
        if c is None:
            raise S3Error("InvalidAccessKeyId")
        return c

    def _check_date(self, amz_date: str) -> None:
        try:
            t = datetime.datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=datetime.timezone.utc
            )
        except ValueError:
            raise S3Error("AuthorizationHeaderMalformed")
        if self.check_skew:
            skew = abs((datetime.datetime.now(datetime.timezone.utc) - t).total_seconds())
            if skew > MAX_SKEW_SECONDS:
                raise S3Error("RequestTimeTooSkewed")

    def verify_signed(
        self,
        method: str,
        path: str,
        query: list[tuple[str, str]],
        headers: dict[str, str],
        payload: bytes | None,
    ) -> str:
        """Verify a header-signed request; returns the access key
        (doesSignatureMatch, cmd/signature-v4.go:334 equivalent).

        payload=None means the caller verifies the payload hash itself while
        streaming the body (the reference's hash.Reader discipline); the
        signature is still checked against the declared header hash."""
        headers = {k.lower(): v for k, v in headers.items()}
        auth = parse_authorization(headers.get("authorization", ""))
        creds = self._creds(auth.access_key)
        amz_date = headers.get("x-amz-date", headers.get("date", ""))
        self._check_date(amz_date)
        payload_hash = headers.get("x-amz-content-sha256", UNSIGNED_PAYLOAD)
        if payload is not None and payload_hash not in (UNSIGNED_PAYLOAD, STREAMING_PAYLOAD):
            if hashlib.sha256(payload).hexdigest() != payload_hash:
                raise S3Error("XAmzContentSHA256Mismatch")
        scope = f"{auth.date}/{auth.region}/s3/aws4_request"
        creq = canonical_request(
            method, path, query, headers, auth.signed_headers, payload_hash
        )
        sts = string_to_sign(amz_date, scope, creq)
        want = hmac.new(
            signing_key(creds.secret_key, auth.date, auth.region),
            sts.encode(),
            hashlib.sha256,
        ).hexdigest()
        if not hmac.compare_digest(want, auth.signature):
            raise S3Error("SignatureDoesNotMatch")
        return auth.access_key

    def presign_url(
        self,
        creds: Credentials,
        method: str,
        path: str,
        query: list[tuple[str, str]],
        host: str,
        expires: int = 3600,
        timestamp: datetime.datetime | None = None,
    ) -> str:
        """Generate a presigned URL (client side)."""
        t = timestamp or datetime.datetime.now(datetime.timezone.utc)
        amz_date = t.strftime("%Y%m%dT%H%M%SZ")
        date = amz_date[:8]
        scope = f"{date}/{self.region}/s3/aws4_request"
        q = list(query) + [
            ("X-Amz-Algorithm", SIGN_V4_ALGORITHM),
            ("X-Amz-Credential", f"{creds.access_key}/{scope}"),
            ("X-Amz-Date", amz_date),
            ("X-Amz-Expires", str(expires)),
            ("X-Amz-SignedHeaders", "host"),
        ]
        creq = canonical_request(
            method, path, q, {"host": host}, ["host"], UNSIGNED_PAYLOAD
        )
        sts = string_to_sign(amz_date, scope, creq)
        sig = hmac.new(
            signing_key(creds.secret_key, date, self.region), sts.encode(), hashlib.sha256
        ).hexdigest()
        qs = urllib.parse.urlencode(q + [("X-Amz-Signature", sig)])
        return f"http://{host}{path}?{qs}"

    def verify_presigned(
        self,
        method: str,
        path: str,
        query: list[tuple[str, str]],
        headers: dict[str, str],
    ) -> str:
        """Verify a presigned request; returns the access key
        (doesPresignedSignatureMatch equivalent)."""
        qd = dict(query)
        try:
            if qd.get("X-Amz-Algorithm") != SIGN_V4_ALGORITHM:
                raise S3Error("AuthorizationHeaderMalformed")
            cred = qd["X-Amz-Credential"].split("/")
            access_key = "/".join(cred[:-4])
            date, region, service, terminal = cred[-4:]
            amz_date = qd["X-Amz-Date"]
            expires = int(qd.get("X-Amz-Expires", "3600"))
            signed_headers = qd["X-Amz-SignedHeaders"].split(";")
            given_sig = qd["X-Amz-Signature"]
        except (KeyError, ValueError):
            raise S3Error("AuthorizationHeaderMalformed")
        creds = self._creds(access_key)
        t = datetime.datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc
        )
        if self.check_skew:
            now = datetime.datetime.now(datetime.timezone.utc)
            if now > t + datetime.timedelta(seconds=expires):
                raise S3Error("ExpiredPresignRequest")
            if now < t - datetime.timedelta(seconds=MAX_SKEW_SECONDS):
                raise S3Error("RequestTimeTooSkewed")
        headers = {k.lower(): v for k, v in headers.items()}
        scope = f"{date}/{region}/s3/aws4_request"
        creq = canonical_request(
            method,
            path,
            query,
            headers,
            signed_headers,
            UNSIGNED_PAYLOAD,
            skip_query={"X-Amz-Signature"},
        )
        sts = string_to_sign(amz_date, scope, creq)
        want = hmac.new(
            signing_key(creds.secret_key, date, region), sts.encode(), hashlib.sha256
        ).hexdigest()
        if not hmac.compare_digest(want, given_sig):
            raise S3Error("SignatureDoesNotMatch")
        return access_key
