"""Input readers: CSV and JSON record iterators.

Equivalent of the reference's ``internal/s3select/csv/reader.go`` and
``internal/s3select/json/reader.go`` (plus Lines/Document handling). Readers
consume raw object bytes (post-decompression) and yield Record objects.
"""

from __future__ import annotations

import bz2
import csv as _csv
import gzip
import io
import json as _json
import zlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

from .records import CSVRecord, JSONRecord


class ReaderError(Exception):
    pass


@dataclass
class CSVArgs:
    file_header_info: str = "NONE"  # NONE | USE | IGNORE
    record_delimiter: str = "\n"
    field_delimiter: str = ","
    quote_character: str = '"'
    quote_escape_character: str = '"'
    comments: str = ""
    allow_quoted_record_delimiter: bool = False


@dataclass
class JSONArgs:
    json_type: str = "LINES"  # LINES | DOCUMENT


@dataclass
class OutputCSVArgs:
    quote_fields: str = "ASNEEDED"  # ALWAYS | ASNEEDED
    record_delimiter: str = "\n"
    field_delimiter: str = ","
    quote_character: str = '"'
    quote_escape_character: str = '"'


@dataclass
class OutputJSONArgs:
    record_delimiter: str = "\n"


def decompress(data: bytes, compression: str) -> bytes:
    c = (compression or "NONE").upper()
    if c in ("", "NONE"):
        return data
    if c == "GZIP":
        return gzip.decompress(data)
    if c == "BZIP2":
        return bz2.decompress(data)
    if c in ("ZLIB",):
        return zlib.decompress(data)
    # SNAPPY/S2/ZSTD/LZ4 need codecs not present in this environment; the
    # reference gates these the same way behind optional libraries.
    raise ReaderError(f"unsupported compression type {compression}")


def _apply_scan_range(data: bytes, record_delim: bytes, start: Optional[int], end: Optional[int]) -> bytes:
    """AWS ScanRange semantics for line-oriented formats: process records that
    *start* within [start, end]; a record straddling `end` is fully processed;
    a partial record at `start` is skipped (its owner is the prior range)."""
    if start is None and end is None:
        return data
    s = start or 0
    e = end if end is not None else max(len(data) - 1, 0)
    if s == 0:
        lo = 0
    elif s >= len(record_delim) and data[s - len(record_delim):s] == record_delim:
        lo = s  # range begins exactly at a record boundary
    else:
        idx = data.find(record_delim, s)
        if idx < 0:
            return b""
        lo = idx + len(record_delim)
    # extend to the end of the record containing byte e
    idx = data.find(record_delim, e)
    hi = len(data) if idx < 0 else idx + len(record_delim)
    return data[lo:hi] if hi > lo else b""


def csv_records(
    data: bytes,
    args: CSVArgs,
    scan_start: Optional[int] = None,
    scan_end: Optional[int] = None,
) -> Iterator[CSVRecord]:
    text_delim = args.record_delimiter or "\n"
    raw = _apply_scan_range(data, text_delim.encode(), scan_start, scan_end)
    text = raw.decode("utf-8", errors="replace")
    if text_delim not in ("\n", "\r\n"):
        text = text.replace(text_delim, "\n")
    src = io.StringIO(text)

    class _Dialect(_csv.Dialect):
        delimiter = args.field_delimiter or ","
        quotechar = args.quote_character or '"'
        escapechar = (
            args.quote_escape_character
            if args.quote_escape_character and args.quote_escape_character != (args.quote_character or '"')
            else None
        )
        doublequote = args.quote_escape_character == (args.quote_character or '"') or not args.quote_escape_character
        lineterminator = "\n"
        quoting = _csv.QUOTE_MINIMAL
        skipinitialspace = False
        strict = False

    reader = _csv.reader(src, dialect=_Dialect())
    names: Optional[List[str]] = None
    header_mode = (args.file_header_info or "NONE").upper()
    first = True
    for row in reader:
        if not row:
            continue
        if args.comments and row[0].startswith(args.comments):
            continue
        if first and header_mode in ("USE", "IGNORE") and scan_start in (None, 0):
            first = False
            if header_mode == "USE":
                names = [c.strip() for c in row]
            continue
        first = False
        yield CSVRecord(row, names)


def json_records(
    data: bytes,
    args: JSONArgs,
    scan_start: Optional[int] = None,
    scan_end: Optional[int] = None,
) -> Iterator[JSONRecord]:
    jtype = (args.json_type or "LINES").upper()
    if jtype == "LINES":
        raw = _apply_scan_range(data, b"\n", scan_start, scan_end)
        dec = _json.JSONDecoder()
        text = raw.decode("utf-8", errors="replace")
        i = 0
        n = len(text)
        while i < n:
            while i < n and text[i] in " \t\r\n":
                i += 1
            if i >= n:
                break
            try:
                obj, j = dec.raw_decode(text, i)
            except ValueError as e:
                raise ReaderError(f"invalid JSON at byte {i}: {e}") from e
            yield JSONRecord(obj)
            i = j
        return
    if jtype == "DOCUMENT":
        text = data.decode("utf-8", errors="replace")
        dec = _json.JSONDecoder()
        i = 0
        n = len(text)
        seen = False
        while i < n:
            while i < n and text[i] in " \t\r\n":
                i += 1
            if i >= n:
                break
            try:
                obj, i = dec.raw_decode(text, i)
            except ValueError as e:
                raise ReaderError(f"invalid JSON document: {e}") from e
            seen = True
            yield JSONRecord(obj)
        if not seen:
            raise ReaderError("empty JSON document")
        return
    raise ReaderError(f"unsupported JSON type {args.json_type}")
