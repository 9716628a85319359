"""Streaming signature V4 (aws-chunked) encoding and verification.

Role of the reference's cmd/streaming-signature-v4.go
(``newSignV4ChunkedReader`` :160): the client splits the payload into chunks,
each carrying a signature chained from the previous one; the server verifies
every chunk signature while decoding.

Wire format per chunk::

    <hex-size>;chunk-signature=<sig>\r\n
    <size bytes of data>\r\n

terminated by a zero-size chunk whose signature covers the empty hash.
"""

from __future__ import annotations

import hashlib
import hmac

from ..control.profiler import COPIED, GLOBAL_PROFILER, MOVED
from .auth import Credentials, STREAMING_PAYLOAD, signing_key
from .errors import S3Error

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
MAX_CHUNK_SIZE = 16 * (1 << 20)  # reference maxChunkSize, streaming-signature-v4.go

# Header lines are parsed out of a small carry buffer; reads this size keep
# the spill (payload bytes swallowed with a header) bounded and cheap while
# one read usually covers a whole "<hex-size>;chunk-signature=<64 hex>" line.
_HEADER_READ = 256


def _chunk_digest_string_to_sign(
    amz_date: str, scope: str, prev_sig: str, chunk_sha_hex: str
) -> str:
    return "\n".join(
        [
            "AWS4-HMAC-SHA256-PAYLOAD",
            amz_date,
            scope,
            prev_sig,
            _EMPTY_SHA256,
            chunk_sha_hex,
        ]
    )


def _chunk_string_to_sign(amz_date: str, scope: str, prev_sig: str, chunk: bytes) -> str:
    return _chunk_digest_string_to_sign(
        amz_date, scope, prev_sig, hashlib.sha256(chunk).hexdigest()
    )


def _sign(key: bytes, msg: str) -> str:
    return hmac.new(key, msg.encode(), hashlib.sha256).hexdigest()


def encode_chunked(
    payload: bytes,
    seed_signature: str,
    creds: Credentials,
    amz_date: str,
    region: str,
    chunk_size: int = 64 * 1024,
) -> bytes:
    """Client side: produce the aws-chunked body for a payload."""
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    key = signing_key(creds.secret_key, date, region)
    out = bytearray()
    prev = seed_signature
    offsets = list(range(0, len(payload), chunk_size)) or [0]
    for off in offsets:
        chunk = payload[off:off + chunk_size]
        sig = _sign(key, _chunk_string_to_sign(amz_date, scope, prev, chunk))
        out += f"{len(chunk):x};chunk-signature={sig}\r\n".encode()
        out += chunk + b"\r\n"
        prev = sig
    final_sig = _sign(key, _chunk_string_to_sign(amz_date, scope, prev, b""))
    out += f"0;chunk-signature={final_sig}\r\n\r\n".encode()
    return bytes(out)


def decode_chunked(
    body: bytes,
    seed_signature: str,
    secret_key: str,
    amz_date: str,
    region: str,
) -> bytes:
    """Server side: decode and verify an aws-chunked body; returns the payload.

    Raises SignatureDoesNotMatch on any broken chunk signature chain.
    """
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    key = signing_key(secret_key, date, region)
    out = bytearray()
    prev = seed_signature
    i = 0
    n = len(body)
    while True:
        nl = body.find(b"\r\n", i)
        if nl < 0:
            raise S3Error("IncompleteBody", "truncated chunk header")
        header = body[i:nl].decode("latin-1")
        i = nl + 2
        if ";" not in header:
            raise S3Error("InvalidRequest", "malformed chunk header")
        size_hex, _, attrs = header.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise S3Error("InvalidRequest", "bad chunk size")
        sig = ""
        for attr in attrs.split(";"):
            k, _, v = attr.partition("=")
            if k.strip() == "chunk-signature":
                sig = v.strip()
        if not sig:
            raise S3Error("InvalidRequest", "missing chunk-signature")
        if i + size > n:
            raise S3Error("IncompleteBody", "truncated chunk data")
        chunk = body[i:i + size]
        i += size
        if body[i:i + 2] != b"\r\n":
            # trailing CRLF after data (the final chunk has an extra blank line)
            raise S3Error("InvalidRequest", "missing chunk trailer")
        i += 2
        want = _sign(key, _chunk_string_to_sign(amz_date, scope, prev, chunk))
        if not hmac.compare_digest(want, sig):
            raise S3Error("SignatureDoesNotMatch", "chunk signature mismatch")
        prev = want
        if size == 0:
            break
        out += chunk
    return bytes(out)


def is_streaming_request(headers: dict) -> bool:
    h = {k.lower(): v for k, v in headers.items()}
    return h.get("x-amz-content-sha256", "") == STREAMING_PAYLOAD


class SignedChunkReader:
    """Incremental aws-chunked decoder+verifier over a sync readinto source.

    The streaming-PUT analogue of decode_chunked: the reference's
    newSignV4ChunkedReader (cmd/streaming-signature-v4.go:160) wraps the
    request body and verifies each chunk's chained signature as the object
    layer consumes it -- memory stays O(header + spill).

    Zero-copy contract: ``readinto(dest)`` decodes chunk payload straight
    into the caller's buffer (the pooled erasure window) -- only header
    lines and the few payload bytes a header read happens to swallow pass
    through the small carry buffer. The chunk signature is checked from an
    incrementally-updated sha256 once the chunk's last byte has landed;
    bytes from a not-yet-verified chunk may therefore already sit in the
    caller's buffer, which is safe because a signature mismatch raises
    before EOF and the PUT path never commits an errored body (staged
    shards are deleted on abort)."""

    def __init__(self, reader, seed_signature: str, secret_key: str, amz_date: str, region: str):
        self._r = reader
        self._amz_date = amz_date
        date = amz_date[:8]
        self._scope = f"{date}/{region}/s3/aws4_request"
        self._key = signing_key(secret_key, date, region)
        self._prev = seed_signature
        self._raw = bytearray()  # carry: header bytes + payload spill
        self._data_left = 0      # payload bytes remaining in current chunk
        self._sha = None         # running sha256 of current chunk payload
        self._sig = ""           # declared signature of current chunk
        self._done = False

    def _read_header_line(self) -> str:
        while True:
            nl = self._raw.find(b"\r\n")
            if nl >= 0:
                line = bytes(self._raw[:nl]).decode("latin-1")
                del self._raw[: nl + 2]
                return line
            if len(self._raw) > 16384:
                raise S3Error("InvalidRequest", "oversized chunk header")
            chunk = self._r.read(_HEADER_READ)
            if not chunk:
                raise S3Error("IncompleteBody", "truncated chunk header")
            self._raw += chunk

    def _verify_sig(self, chunk_sha_hex: str) -> None:
        want = _sign(
            self._key,
            _chunk_digest_string_to_sign(
                self._amz_date, self._scope, self._prev, chunk_sha_hex
            ),
        )
        if not hmac.compare_digest(want, self._sig):
            raise S3Error("SignatureDoesNotMatch", "chunk signature mismatch")
        self._prev = want

    def _begin_chunk(self) -> None:
        header = self._read_header_line()
        if ";" not in header:
            raise S3Error("InvalidRequest", "malformed chunk header")
        size_hex, _, attrs = header.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise S3Error("InvalidRequest", "bad chunk size")
        if size > MAX_CHUNK_SIZE:
            # Memory stays bounded: a declared terabyte chunk must not
            # buffer before its signature check (the reference caps chunks
            # at 16 MiB, streaming-signature-v4.go maxChunkSize).
            raise S3Error("InvalidRequest", "chunk size exceeds maximum")
        sig = ""
        for attr in attrs.split(";"):
            k, _, v = attr.partition("=")
            if k.strip() == "chunk-signature":
                sig = v.strip()
        if not sig:
            raise S3Error("InvalidRequest", "missing chunk-signature")
        self._sig = sig
        if size == 0:
            self._verify_sig(_EMPTY_SHA256)
            self._done = True
            return
        self._data_left = size
        self._sha = hashlib.sha256()

    def _finish_chunk(self) -> None:
        """Current chunk's payload fully landed: trailer CRLF + signature."""
        while len(self._raw) < 2:
            more = self._r.read(_HEADER_READ)
            if not more:
                raise S3Error("IncompleteBody", "truncated chunk data")
            self._raw += more
        if self._raw[:2] != b"\r\n":
            raise S3Error("InvalidRequest", "missing chunk trailer")
        del self._raw[:2]
        self._verify_sig(self._sha.hexdigest())
        self._sha = None

    def _land(self, dest, want: int) -> int:
        """Move up to `want` payload bytes into dest[:], carry buffer first."""
        if self._raw:
            t = min(want, len(self._raw))
            dest[:t] = self._raw[:t]
            del self._raw[:t]
            return t
        ri = getattr(self._r, "readinto", None)
        if ri is not None:
            t = ri(dest[:want])
            if not t:
                raise S3Error("IncompleteBody", "truncated chunk data")
            return t
        b = self._r.read(want)
        if not b:
            raise S3Error("IncompleteBody", "truncated chunk data")
        dest[: len(b)] = b
        return len(b)

    def _decode_into(self, dest: memoryview) -> int:
        total = 0
        n = len(dest)
        while total < n and not self._done:
            if self._data_left:
                t = self._land(dest[total:], min(self._data_left, n - total))
                self._sha.update(dest[total : total + t])
                self._data_left -= t
                total += t
                if self._data_left == 0:
                    self._finish_chunk()
            else:
                self._begin_chunk()
        return total

    def readinto(self, dest) -> int:
        """Decode verified payload straight into `dest` (a writable buffer);
        returns bytes landed, 0 at end of the chunked body."""
        if not isinstance(dest, memoryview):
            dest = memoryview(dest)
        total = self._decode_into(dest)
        if total:
            # Copy-ledger hop: payload decodes straight into the caller's
            # pooled buffer -- verified bytes are never restaged.
            GLOBAL_PROFILER.copy.record("sigv4-chunk-parse", MOVED, total)
        return total

    def read(self, n: int) -> bytes:
        """Legacy bytes-returning fallback for non-pooled consumers."""
        if n <= 0:
            return b""
        buf = bytearray(n)
        got = self._decode_into(memoryview(buf))
        if got:
            GLOBAL_PROFILER.copy.record("sigv4-chunk-parse", COPIED, got)
        return bytes(buf[:got])
