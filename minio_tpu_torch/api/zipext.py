"""S3 zip extension: list/get files inside zip objects without extraction.

Role of the reference's s3-zip-handlers.go (518 LoC, zipindex-powered):
with the `x-minio-extract: true` header, `GET bucket/archive.zip/inner.txt`
serves a single file from inside a stored zip, and ListObjectsV2 with a
`archive.zip/` prefix lists the archive's entries as pseudo-objects.

The reference reads only the zip central directory via ranged reads
(zipindex); here the archive passes through the object layer's logical read
(so SSE/compression/tiering transforms apply) and the stdlib zipfile parses
it — same wire behavior, observably identical listings and bytes.
"""

from __future__ import annotations

import io
import mimetypes
import zipfile
from dataclasses import dataclass

EXTRACT_HEADER = "x-minio-extract"
ZIP_SEP = ".zip/"


def wants_extract(headers) -> bool:
    return headers.get(EXTRACT_HEADER, "").lower() == "true"


def split_zip_path(key: str) -> tuple[str, str] | None:
    """'docs/a.zip/dir/f.txt' -> ('docs/a.zip', 'dir/f.txt'); None when the
    key has no zip component (s3-zip-handlers.go splitZipExtensionPath)."""
    i = key.find(ZIP_SEP)
    if i < 0:
        return None
    return key[: i + 4], key[i + 5 :]


@dataclass
class ZipEntry:
    name: str
    size: int
    mod_time: float
    crc: int

    @property
    def etag(self) -> str:
        return f"{self.crc:08x}"


def _entry_mtime(info: zipfile.ZipInfo) -> float:
    import calendar

    try:
        return calendar.timegm(tuple(info.date_time) + (0, 0, -1))
    except (ValueError, OverflowError):
        return 0.0


def _entry_of(info: zipfile.ZipInfo) -> ZipEntry:
    return ZipEntry(
        name=info.filename,
        size=info.file_size,
        mod_time=_entry_mtime(info),
        crc=info.CRC,
    )


def list_entries(zip_bytes: bytes) -> list[ZipEntry]:
    """All file entries of the archive in central-directory order."""
    with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
        return [_entry_of(info) for info in zf.infolist() if not info.is_dir()]


def stat_entry(zip_bytes: bytes, inner: str) -> ZipEntry | None:
    """Metadata-only lookup (HEAD): no payload decompression."""
    with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
        try:
            info = zf.getinfo(inner)
        except KeyError:
            return None
        if info.is_dir():
            return None
        return _entry_of(info)


def read_entry(zip_bytes: bytes, inner: str) -> tuple[ZipEntry, bytes] | None:
    with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
        try:
            info = zf.getinfo(inner)
        except KeyError:
            return None
        if info.is_dir():
            return None
        return _entry_of(info), zf.read(info)


def content_type(name: str) -> str:
    return mimetypes.guess_type(name)[0] or "application/octet-stream"
