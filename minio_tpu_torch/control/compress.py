"""Transparent object compression (the JAX package's control/compress.py).

Role of the reference's compression path (cmd/object-api-utils.go:442
isCompressible, :907 s2 writer, :686 readahead+s2 reader): objects whose
extension/MIME matches the configured filters are compressed before erasure
coding, with the pre-compression size kept in internal metadata so S3
semantics (Content-Length, ranges) are preserved.

The read side is whole: objects either package wrote decompress here,
snappy through a pure-Python block decoder (the JAX package's copy lives
with its parquet reader) and zlib through the standard library. `compress()`
writes zlib level 1, which is what the JAX package writes without its native
library; the snappy writer comes with the native host codec (ROADMAP.md,
Queue A item 6). The front reaches `compress()` only through a `config`
(item 8). Deliberately NOT a device workload, as in the JAX package.
"""

from __future__ import annotations

import fnmatch
import zlib

META_COMPRESSION = "x-internal-compression"
META_ACTUAL_SIZE = "x-internal-actual-size"
ALGO_SNAPPY = "snappy"
ALGO_ZLIB = "zlib"

# Incompressible content is skipped by extension/MIME, as in the reference.
DEFAULT_EXTENSIONS = [".txt", ".log", ".csv", ".json", ".tar", ".xml", ".bin"]
DEFAULT_MIME = ["text/*", "application/json", "application/xml"]


def is_compressible(
    object_name: str,
    content_type: str,
    extensions: list[str] | None = None,
    mime_types: list[str] | None = None,
) -> bool:
    exts = extensions if extensions is not None else DEFAULT_EXTENSIONS
    mimes = mime_types if mime_types is not None else DEFAULT_MIME
    if any(object_name.endswith(e) for e in exts):
        return True
    return any(fnmatch.fnmatchcase(content_type, m) for m in mimes)


def compress(data: bytes) -> tuple[bytes, dict[str, str]]:
    out = zlib.compress(data, level=1)
    return out, {META_COMPRESSION: ALGO_ZLIB, META_ACTUAL_SIZE: str(len(data))}


def decompress(blob: bytes, meta: dict[str, str]) -> bytes:
    algo = meta.get(META_COMPRESSION)
    if algo == ALGO_SNAPPY:
        return snappy_decompress(blob)
    if algo == ALGO_ZLIB:
        return zlib.decompress(blob)
    return blob


def is_compressed(meta: dict[str, str]) -> bool:
    return META_COMPRESSION in meta


def snappy_decompress(data: bytes) -> bytes:
    """Snappy block format decoder (the JAX package's
    s3select/parquet.py snappy_decompress); ValueError on corrupt input."""
    i = 0
    # Preamble: uncompressed length varint.
    n = shift = 0
    while True:
        if i >= len(data):
            raise ValueError("snappy: truncated preamble")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while i < len(data):
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(data[i : i + extra], "little") + 1
                i += extra
            out += data[i : i + length]
            i += length
        else:
            if kind == 1:  # copy, 1-byte offset
                length = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[i]
                i += 1
            elif kind == 2:  # copy, 2-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[i : i + 2], "little")
                i += 2
            else:  # copy, 4-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[i : i + 4], "little")
                i += 4
            if offset == 0 or offset > len(out):
                raise ValueError("snappy: bad copy offset")
            start = len(out) - offset
            for k in range(length):  # may overlap: byte-by-byte
                out.append(out[start + k])
    if len(out) != n:
        raise ValueError(f"snappy: length mismatch {len(out)} != {n}")
    return bytes(out)
