"""POST policy form uploads (browser uploads).

Role of the reference's cmd/postpolicyform.go + PostPolicyBucketHandler
(bucket-handlers.go): a multipart/form-data POST to the bucket carrying a
base64 policy document, a V4 signature over it, the object key, and the file
payload. The policy constrains what the form may upload (key prefix,
content-length range, exact-match fields) with an expiration.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .auth import SIGN_V4_ALGORITHM, signing_key
from .errors import S3Error


# ------------------------------------------------------------- form parsing


def parse_multipart_form(body: bytes, content_type: str) -> Dict[str, bytes]:
    """Minimal multipart/form-data parser; returns field name -> value.

    The file part is stored under 'file'; its Content-Disposition filename
    (used for ``${filename}`` key substitution) under '__filename__'.
    (aiohttp's reader needs a live stream; handlers here already hold the
    full body.)
    """
    if "boundary=" not in content_type:
        raise S3Error("MalformedPOSTRequest", "missing multipart boundary")
    boundary = content_type.split("boundary=", 1)[1].split(";")[0].strip().strip('"')
    delim = b"--" + boundary.encode()
    fields: Dict[str, bytes] = {}
    parts = body.split(delim)
    for part in parts[1:]:
        if part.startswith(b"--"):
            break  # closing delimiter
        part = part.lstrip(b"\r\n")
        if b"\r\n\r\n" not in part:
            continue
        raw_headers, _, content = part.partition(b"\r\n\r\n")
        if content.endswith(b"\r\n"):
            content = content[:-2]
        disposition = ""
        for line in raw_headers.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition:"):
                disposition = line.decode("latin-1")
        name = ""
        filename = None
        for attr in disposition.split(";"):
            attr = attr.strip()
            if attr.startswith("name="):
                name = attr[len("name="):].strip('"')
            elif attr.startswith("filename="):
                filename = attr[len("filename="):].strip('"')
        if name:
            fields[name] = content
            if name == "file" and filename is not None:
                fields["__filename__"] = filename.encode()
    return fields


# ------------------------------------------------------------ policy checks


@dataclass
class PostPolicy:
    expiration: Optional[datetime.datetime]
    # list of (kind, key, value[, upper]) conditions
    eq: List[Tuple[str, str]] = field(default_factory=list)
    starts_with: List[Tuple[str, str]] = field(default_factory=list)
    length_range: Optional[Tuple[int, int]] = None

    @classmethod
    def parse(cls, policy_json: bytes) -> "PostPolicy":
        try:
            doc = json.loads(policy_json)
        except ValueError as e:
            raise S3Error("MalformedPOSTRequest", f"invalid policy JSON: {e}")
        exp = None
        if "expiration" in doc:
            raw = doc["expiration"].replace("Z", "+00:00")
            try:
                exp = datetime.datetime.fromisoformat(raw)
            except ValueError:
                raise S3Error("MalformedPOSTRequest", "bad expiration")
            if exp.tzinfo is None:
                exp = exp.replace(tzinfo=datetime.timezone.utc)
        pol = cls(expiration=exp)
        for cond in doc.get("conditions", []):
            if isinstance(cond, dict):
                for k, v in cond.items():
                    pol.eq.append((k.lower(), str(v)))
            elif isinstance(cond, list) and len(cond) >= 3:
                op = str(cond[0]).lower()
                if op == "eq":
                    pol.eq.append((str(cond[1]).lstrip("$").lower(), str(cond[2])))
                elif op == "starts-with":
                    pol.starts_with.append((str(cond[1]).lstrip("$").lower(), str(cond[2])))
                elif op == "content-length-range":
                    pol.length_range = (int(cond[1]), int(cond[2]))
                else:
                    raise S3Error("MalformedPOSTRequest", f"unknown condition {op}")
            else:
                raise S3Error("MalformedPOSTRequest", "bad condition")
        return pol

    def check(self, form: Dict[str, bytes], file_size: int, bucket: str = "") -> None:
        if self.expiration is not None:
            if datetime.datetime.now(datetime.timezone.utc) > self.expiration:
                raise S3Error("AccessDenied", "policy expired")
        lower = {
            k.lower(): v.decode("utf-8", "replace")
            for k, v in form.items()
            if k not in ("file", "__filename__")
        }
        # The bucket comes from the request URL, not a form field.
        lower["bucket"] = bucket
        # Fields whose values the signature itself covers (or that only shape
        # the response), exempt from the must-be-in-policy rule.
        exempt = {"x-amz-signature", "policy", "x-amz-algorithm", "x-amz-credential",
                  "x-amz-date", "bucket"}
        for k, want in self.eq:
            got = lower.get(k)
            if got is None or got != want:
                raise S3Error("AccessDenied", f"policy condition failed: eq ${k}")
        for k, prefix in self.starts_with:
            got = lower.get(k, "")
            if not got.startswith(prefix):
                raise S3Error("AccessDenied", f"policy condition failed: starts-with ${k}")
        if self.length_range is not None:
            lo, hi = self.length_range
            if not (lo <= file_size <= hi):
                raise S3Error("EntityTooLarge" if file_size > hi else "EntityTooSmall")
        # Every other form field must be authorized by some policy condition
        # (matching real S3/MinIO: checkPostPolicy rejects unknown fields).
        allowed = {k for k, _ in self.eq} | {k for k, _ in self.starts_with}
        for k in lower:
            if k in exempt or k in allowed:
                continue
            raise S3Error(
                "AccessDenied", f"form field ${k} not covered by policy conditions"
            )


def verify_post_signature(form: Dict[str, bytes], lookup) -> str:
    """Verify the V4 signature over the base64 policy; returns the access key.

    lookup: access_key -> Credentials | None.
    """
    policy_b64 = form.get("policy", b"").decode()
    algorithm = form.get("x-amz-algorithm", b"").decode()
    credential = form.get("x-amz-credential", b"").decode()
    amz_date = form.get("x-amz-date", b"").decode()
    given = form.get("x-amz-signature", b"").decode()
    if algorithm != SIGN_V4_ALGORITHM:
        raise S3Error("AccessDenied", "unsupported signature algorithm")
    if not policy_b64 or not credential or not given:
        raise S3Error("AccessDenied", "missing policy signature fields")
    parts = credential.split("/")
    if len(parts) < 5 or parts[-1] != "aws4_request":
        raise S3Error("AuthorizationHeaderMalformed")
    access_key = "/".join(parts[:-4])
    date, region, _service, _terminal = parts[-4:]
    creds = lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    key = signing_key(creds.secret_key, date, region)
    want = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, given):
        raise S3Error("SignatureDoesNotMatch")
    return access_key


def build_post_form(
    creds,
    bucket: str,
    key: str,
    data: bytes,
    region: str = "us-east-1",
    expires_in: int = 3600,
    extra_conditions: Optional[list] = None,
    extra_fields: Optional[Dict[str, str]] = None,
) -> Tuple[bytes, str]:
    """Client side: build a signed multipart POST body; returns (body, content_type)."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    credential = f"{creds.access_key}/{date}/{region}/s3/aws4_request"
    expiration = (now + datetime.timedelta(seconds=expires_in)).strftime("%Y-%m-%dT%H:%M:%S.000Z")
    conditions = [
        {"bucket": bucket},
        ["eq", "$key", key],
        {"x-amz-algorithm": SIGN_V4_ALGORITHM},
        {"x-amz-credential": credential},
        {"x-amz-date": amz_date},
    ] + [["eq", f"${k}", v] for k, v in (extra_fields or {}).items()] + (
        extra_conditions or []
    )
    policy = base64.b64encode(
        json.dumps({"expiration": expiration, "conditions": conditions}).encode()
    ).decode()
    sig = hmac.new(
        signing_key(creds.secret_key, date, region), policy.encode(), hashlib.sha256
    ).hexdigest()
    fields = {
        "key": key,
        "x-amz-algorithm": SIGN_V4_ALGORITHM,
        "x-amz-credential": credential,
        "x-amz-date": amz_date,
        "policy": policy,
        "x-amz-signature": sig,
    }
    fields.update(extra_fields or {})
    boundary = "----minio-tpu-post-" + hashlib.md5(policy.encode()).hexdigest()[:16]
    out = bytearray()
    for name, value in fields.items():
        out += f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"\r\n\r\n{value}\r\n".encode()
    out += (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"upload\"\r\n"
        "Content-Type: application/octet-stream\r\n\r\n"
    ).encode()
    out += data + f"\r\n--{boundary}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={boundary}"
