"""SelectObjectContent orchestration: request parsing → pipeline → events.

Equivalent of the reference's ``internal/s3select/select.go`` (``S3Select``
struct :218, ``Evaluate`` loop) and ``message.go`` writer. The handler parses
the request XML, streams records through the SQL executor, serializes output
rows, and frames them as AWS event-stream messages.
"""

from __future__ import annotations

import io
import struct as struct_mod
import xml.etree.ElementTree as ET
import zlib
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

from . import eventstream as es
from .eval import SelectEvalError, StatementExecutor
from .readers import (
    CSVArgs,
    JSONArgs,
    OutputCSVArgs,
    OutputJSONArgs,
    ReaderError,
    csv_records,
    decompress,
    json_records,
)
from .sql import SQLParseError, parse
from .value import MISSING, SelectValueError, to_string


class SelectError(Exception):
    def __init__(self, code: str, message: str, status: int = 400):
        super().__init__(message)
        self.code = code
        self.message = message
        self.status = status


@dataclass
class S3SelectRequest:
    expression: str
    expression_type: str = "SQL"
    input_format: str = "csv"  # csv | json | parquet
    compression: str = "NONE"
    csv_args: CSVArgs = field(default_factory=CSVArgs)
    json_args: JSONArgs = field(default_factory=JSONArgs)
    output_format: str = "csv"
    out_csv: OutputCSVArgs = field(default_factory=OutputCSVArgs)
    out_json: OutputJSONArgs = field(default_factory=OutputJSONArgs)
    progress: bool = False
    scan_start: Optional[int] = None
    scan_end: Optional[int] = None

    @classmethod
    def from_xml(cls, body: bytes) -> "S3SelectRequest":
        try:
            root = ET.fromstring(body)
        except ET.ParseError as e:
            raise SelectError("MalformedXML", f"invalid request XML: {e}") from e
        strip = lambda t: t.split("}", 1)[-1]  # drop xmlns
        nodes = {}

        def walk(el, prefix=""):
            name = prefix + strip(el.tag)
            nodes[name] = el
            for c in el:
                walk(c, name + "/")

        walk(root)
        root_name = strip(root.tag)
        if root_name != "SelectObjectContentRequest":
            raise SelectError("MalformedXML", "expected SelectObjectContentRequest")
        p = "SelectObjectContentRequest/"

        def text(path, default=None):
            el = nodes.get(p + path)
            return el.text if el is not None and el.text is not None else default

        expr = text("Expression")
        if not expr:
            raise SelectError("MissingRequiredParameter", "Expression is required")
        req = cls(expression=expr)
        req.expression_type = (text("ExpressionType", "SQL") or "SQL").upper()
        if req.expression_type != "SQL":
            raise SelectError("InvalidExpressionType", "ExpressionType must be SQL")

        inser = p + "InputSerialization"
        if inser not in nodes:
            raise SelectError("MissingRequiredParameter", "InputSerialization is required")
        req.compression = (text("InputSerialization/CompressionType", "NONE") or "NONE").upper()
        if p + "InputSerialization/CSV" in nodes:
            req.input_format = "csv"
            a = req.csv_args
            a.file_header_info = (text("InputSerialization/CSV/FileHeaderInfo", "NONE") or "NONE").upper()
            a.record_delimiter = text("InputSerialization/CSV/RecordDelimiter", "\n") or "\n"
            a.field_delimiter = text("InputSerialization/CSV/FieldDelimiter", ",") or ","
            a.quote_character = text("InputSerialization/CSV/QuoteCharacter", '"') or '"'
            a.quote_escape_character = text("InputSerialization/CSV/QuoteEscapeCharacter", '"') or '"'
            a.comments = text("InputSerialization/CSV/Comments", "") or ""
        elif p + "InputSerialization/JSON" in nodes:
            req.input_format = "json"
            req.json_args.json_type = (text("InputSerialization/JSON/Type", "LINES") or "LINES").upper()
        elif p + "InputSerialization/Parquet" in nodes:
            req.input_format = "parquet"
        else:
            raise SelectError("InvalidDataSource", "unsupported input serialization")

        outser = p + "OutputSerialization"
        if outser not in nodes:
            raise SelectError("MissingRequiredParameter", "OutputSerialization is required")
        if p + "OutputSerialization/JSON" in nodes:
            req.output_format = "json"
            req.out_json.record_delimiter = text("OutputSerialization/JSON/RecordDelimiter", "\n") or "\n"
        else:
            req.output_format = "csv"
            o = req.out_csv
            o.quote_fields = (text("OutputSerialization/CSV/QuoteFields", "ASNEEDED") or "ASNEEDED").upper()
            o.record_delimiter = text("OutputSerialization/CSV/RecordDelimiter", "\n") or "\n"
            o.field_delimiter = text("OutputSerialization/CSV/FieldDelimiter", ",") or ","
            o.quote_character = text("OutputSerialization/CSV/QuoteCharacter", '"') or '"'
            o.quote_escape_character = text("OutputSerialization/CSV/QuoteEscapeCharacter", '"') or '"'

        req.progress = (text("RequestProgress/Enabled", "false") or "false").lower() == "true"
        sr_start = text("ScanRange/Start")
        sr_end = text("ScanRange/End")
        if sr_start is not None:
            req.scan_start = int(sr_start)
        if sr_end is not None:
            req.scan_end = int(sr_end)
        if req.scan_start is not None and req.scan_end is not None and req.scan_start > req.scan_end:
            raise SelectError("InvalidScanRange", "ScanRange Start must be <= End")
        return req


def _serialize_value(v) -> str:
    if v is None or v is MISSING:
        return ""
    return to_string(v)


def _csv_field(s: str, o: OutputCSVArgs) -> str:
    need_quote = o.quote_fields == "ALWAYS" or any(
        ch in s for ch in (o.field_delimiter, o.quote_character, "\n", "\r")
    )
    if not need_quote:
        return s
    q = o.quote_character
    esc = o.quote_escape_character or q
    body = s.replace(q, esc + q)
    return f"{q}{body}{q}"


def _row_csv(names: List[str], values: List, o: OutputCSVArgs) -> str:
    return o.field_delimiter.join(_csv_field(_serialize_value(v), o) for v in values) + o.record_delimiter


def _row_json(names: List[str], values: List, o: OutputJSONArgs) -> str:
    import datetime as _dt
    import json as _json

    def conv(v):
        if v is MISSING:
            return None
        if isinstance(v, _dt.datetime):
            from .value import format_timestamp
            return format_timestamp(v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    obj = {}
    for n, v in zip(names, values):
        if v is MISSING:
            continue  # MISSING columns are omitted, NULL serializes as null
        obj[n] = conv(v)
    return _json.dumps(obj, separators=(",", ":"), default=str) + o.record_delimiter


def run_select(
    req: S3SelectRequest,
    get_data: Callable[[Optional[int], Optional[int]], bytes],
) -> Iterator[bytes]:
    """Execute the select request; yields event-stream frames.

    ``get_data`` returns the raw (possibly compressed) object bytes. Errors
    mid-stream surface as an error frame, matching the reference behavior
    (HTTP 200 already sent; error delivered in-band).
    """
    try:
        stmt = parse(req.expression)
    except SQLParseError as e:
        raise SelectError("ParseSelectFailure", str(e)) from None

    try:
        executor = StatementExecutor(stmt)
    except SelectEvalError as e:
        raise SelectError("InvalidQuery", str(e)) from None

    raw = get_data(None, None)
    scanned = len(raw)
    try:
        data = decompress(raw, req.compression)
    except ReaderError as e:
        raise SelectError("InvalidCompressionFormat", str(e)) from None
    except OSError as e:
        raise SelectError("InvalidCompressionFormat", f"decompress failed: {e}") from None
    processed = len(data)

    if req.input_format == "parquet":
        from . import parquet as parquet_mod
        from .records import JSONRecord

        if req.scan_start is not None or req.scan_end is not None:
            # AWS/the reference reject ScanRange for parquet (it is only
            # defined for CSV/JSON byte streams).
            raise SelectError(
                "UnsupportedScanRangeInput", "ScanRange is not supported for Parquet"
            )
        try:
            _names, rows = parquet_mod.read_rows(data)
        except parquet_mod.ParquetError as e:
            raise SelectError("InvalidDataSource", f"parquet: {e}") from None
        except (IndexError, KeyError, struct_mod.error, zlib.error, ValueError) as e:
            # Hand-rolled binary parser: any malformed-input failure mode is
            # the same client error, never a 500.
            raise SelectError(
                "InvalidDataSource", f"parquet: corrupt file ({type(e).__name__})"
            ) from None
        records = (JSONRecord(row) for row in rows)
    elif req.input_format == "csv":
        records = csv_records(data, req.csv_args, req.scan_start, req.scan_end)
    else:
        records = json_records(data, req.json_args, req.scan_start, req.scan_end)

    returned = 0
    buf = io.BytesIO()
    FLUSH = 128 << 10

    def serialize(names, values) -> bytes:
        if req.output_format == "json":
            return _row_json(names, values, req.out_json).encode()
        return _row_csv(names, values, req.out_csv).encode()

    try:
        for record in records:
            for names, values in executor.feed(record):
                row = serialize(names, values)
                buf.write(row)
                returned += len(row)
                if buf.tell() >= FLUSH:
                    yield es.records_message(buf.getvalue())
                    buf = io.BytesIO()
            if executor.limit_reached() and not executor.is_aggregate:
                break
        for names, values in executor.finish():
            row = serialize(names, values)
            buf.write(row)
            returned += len(row)
    except (SelectEvalError, SelectValueError, ReaderError) as e:
        if buf.tell():
            yield es.records_message(buf.getvalue())
        code = "InvalidQuery" if isinstance(e, SelectEvalError) else (
            "InvalidTextEncoding" if isinstance(e, ReaderError) else "CastFailed"
        )
        yield es.error_message(code, str(e))
        return

    if buf.tell():
        yield es.records_message(buf.getvalue())
    if req.progress:
        yield es.progress_message(scanned, processed, returned)
    yield es.stats_message(scanned, processed, returned)
    yield es.end_message()
