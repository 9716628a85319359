"""Transparent object compression (the JAX package's control/compress.py).

Role of the reference's compression path (cmd/object-api-utils.go:442
isCompressible, :907 s2 writer, :686 readahead+s2 reader): objects whose
extension/MIME matches the configured filters are compressed before erasure
coding, with the pre-compression size kept in internal metadata so S3
semantics (Content-Length, ranges) are preserved.

Codec: snappy block format through the port's native host library
(ops/native.py; the reference's S2 is a snappy superset), which is what the
JAX package writes whenever its own native library loads. The host library
builds at first use and raises when it cannot: no zlib writer stands in for
it. Reads accept both formats, so objects either package wrote, with either
codec, decompress here; the parquet reader's pure-Python snappy decoder
(s3select/parquet.py) is kept here as an independent reader for tests.
The S3 front compresses when its config's compression subsystem is on
(control/config.py, admin /config). Deliberately NOT a device workload, as
in the JAX package.
"""

from __future__ import annotations

import fnmatch
import zlib

from ..ops import native

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
    out = native.snappy_compress(data)
    return out, {META_COMPRESSION: ALGO_SNAPPY, META_ACTUAL_SIZE: str(len(data))}


def decompress(blob: bytes, meta: dict[str, str]) -> bytes:
    algo = meta.get(META_COMPRESSION)
    if algo == ALGO_SNAPPY:
        return native.snappy_decompress(blob)
    if algo == ALGO_ZLIB:
        return zlib.decompress(blob)
    return blob


def is_compressed(meta: dict[str, str]) -> bool:
    return META_COMPRESSION in meta


def snappy_decompress(data: bytes) -> bytes:
    """The parquet reader's pure-Python snappy decoder (s3select/parquet.py);
    ValueError on corrupt input."""
    from ..s3select import parquet

    try:
        return parquet.snappy_decompress(data)
    except parquet.ParquetError as e:
        raise ValueError(str(e)) from e
