"""Pure-Python Parquet reader for S3 Select.

Role of the reference's internal/s3select/parquet (reader.go over
parquet-go): stream rows out of flat Parquet files for SELECT queries.
This build has no Arrow/parquet library, so the format is implemented
directly from the Apache Parquet spec:

  * Thrift compact protocol for FileMetaData / PageHeader,
  * PLAIN + RLE_DICTIONARY/PLAIN_DICTIONARY encodings,
  * RLE/bit-packed hybrid definition levels (flat optional columns),
  * UNCOMPRESSED, SNAPPY (hand-rolled decompressor), GZIP codecs,
  * data page v1 and v2,
  * BOOLEAN/INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY physical types with
    UTF8/DECIMAL/DATE/TIMESTAMP converted types surfaced sensibly.

Nested (repeated) schemas are rejected with a clear error — the S3 Select
SQL engine is row/column oriented and the reference rejects them too.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field


class ParquetError(Exception):
    pass


MAGIC = b"PAR1"

# Physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)

# Encodings
ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_RLE_DICTIONARY = 8

# Codecs
CODEC_UNCOMPRESSED = 0
CODEC_SNAPPY = 1
CODEC_GZIP = 2

# Page types
PAGE_DATA = 0
PAGE_DICTIONARY = 2
PAGE_DATA_V2 = 3


# ---------------------------------------------------------------------------
# Snappy block decompression (no external lib; the format is tiny)
# ---------------------------------------------------------------------------


def snappy_decompress(data: bytes) -> bytes:
    i = 0
    # Preamble: uncompressed length varint.
    n = shift = 0
    while True:
        if i >= len(data):
            raise ParquetError("snappy: truncated preamble")
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
                raise ParquetError("snappy: bad copy offset")
            start = len(out) - offset
            for k in range(length):  # may overlap: byte-by-byte
                out.append(out[start + k])
    if len(out) != n:
        raise ParquetError(f"snappy: length mismatch {len(out)} != {n}")
    return bytes(out)


def _decompress(codec: int, data: bytes, uncompressed_size: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec == CODEC_SNAPPY:
        return snappy_decompress(data)
    if codec == CODEC_GZIP:
        return zlib.decompress(data, wbits=31)
    raise ParquetError(f"unsupported codec {codec}")


# ---------------------------------------------------------------------------
# Thrift compact protocol (read-only subset)
# ---------------------------------------------------------------------------

CT_STOP, CT_TRUE, CT_FALSE, CT_BYTE, CT_I16, CT_I32, CT_I64, CT_DOUBLE, CT_BINARY, CT_LIST, CT_SET, CT_MAP, CT_STRUCT = range(13)


class ThriftReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _uvarint(self) -> int:
        n = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    def _zigzag(self) -> int:
        n = self._uvarint()
        return (n >> 1) ^ -(n & 1)

    def read_value(self, ctype: int):
        if ctype in (CT_TRUE, CT_FALSE):
            return ctype == CT_TRUE
        if ctype == CT_BYTE:
            v = self.buf[self.pos]
            self.pos += 1
            return v - 256 if v > 127 else v
        if ctype in (CT_I16, CT_I32, CT_I64):
            return self._zigzag()
        if ctype == CT_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ctype == CT_BINARY:
            n = self._uvarint()
            v = self.buf[self.pos : self.pos + n]
            self.pos += n
            return v
        if ctype == CT_LIST or ctype == CT_SET:
            head = self.buf[self.pos]
            self.pos += 1
            size = head >> 4
            elem = head & 0x0F
            if size == 15:
                size = self._uvarint()
            return [self.read_value(elem) for _ in range(size)]
        if ctype == CT_STRUCT:
            return self.read_struct()
        if ctype == CT_MAP:
            size = self._uvarint()
            if size == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            kt, vt = kv >> 4, kv & 0x0F
            return {self.read_value(kt): self.read_value(vt) for _ in range(size)}
        raise ParquetError(f"thrift: unsupported type {ctype}")

    def read_struct(self) -> dict[int, object]:
        """Struct -> {field id: value}; nested structs are dicts too."""
        out: dict[int, object] = {}
        last_id = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == CT_STOP:
                return out
            delta = head >> 4
            ctype = head & 0x0F
            if delta:
                fid = last_id + delta
            else:
                fid = self._zigzag()
            last_id = fid
            out[fid] = self.read_value(ctype)


# ---------------------------------------------------------------------------
# Metadata model
# ---------------------------------------------------------------------------


@dataclass
class Column:
    name: str
    physical_type: int
    converted_type: int | None
    max_def_level: int
    # per-file accumulation
    chunks: list[dict] = field(default_factory=list)


@dataclass
class ParquetFile:
    columns: list[Column]
    num_rows: int
    row_groups: list[list[dict]]  # row group -> [column chunk meta in column order]


def _schema_columns(schema: list[dict]) -> list[Column]:
    """Flatten the schema element list (field ids per parquet.thrift
    SchemaElement: 1=type, 3=repetition_type, 4=name, 5=num_children,
    6=converted_type)."""
    if not schema:
        raise ParquetError("empty schema")
    root = schema[0]
    n_children = root.get(5, 0)
    cols: list[Column] = []
    idx = 1
    for _ in range(int(n_children)):
        if idx >= len(schema):
            raise ParquetError("schema underflow")
        el = schema[idx]
        idx += 1
        if el.get(5):  # group node: nested schema
            raise ParquetError("nested schemas are not supported by S3 Select")
        rep = el.get(3, 0)  # 0 required, 1 optional, 2 repeated
        if rep == 2:
            raise ParquetError("repeated fields are not supported by S3 Select")
        cols.append(
            Column(
                name=el[4].decode() if isinstance(el.get(4), bytes) else str(el.get(4)),
                physical_type=int(el.get(1, BYTE_ARRAY)),
                converted_type=int(el[6]) if 6 in el else None,
                max_def_level=1 if rep == 1 else 0,
            )
        )
    return cols


def parse_metadata(data: bytes) -> ParquetFile:
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetError("not a parquet file")
    meta_len = int.from_bytes(data[-8:-4], "little")
    meta_start = len(data) - 8 - meta_len
    if meta_start < 4:
        raise ParquetError("corrupt footer")
    fmd = ThriftReader(data, meta_start).read_struct()
    # FileMetaData: 2=schema, 3=num_rows, 4=row_groups
    cols = _schema_columns(fmd.get(2, []))  # type: ignore[arg-type]
    by_name = {c.name: i for i, c in enumerate(cols)}
    row_groups = []
    for rg in fmd.get(4, []):  # type: ignore[union-attr]
        # RowGroup: 1=columns
        chunk_metas: list[dict | None] = [None] * len(cols)
        for cc in rg.get(1, []):
            # ColumnChunk: 3=meta_data; ColumnMetaData fields:
            # 1=type 3=path_in_schema 4=codec 5=num_values
            # 9=data_page_offset 11=dictionary_page_offset
            md = cc.get(3)
            if md is None:
                raise ParquetError("column chunk without metadata")
            path = md.get(3, [])
            name = path[0].decode() if path and isinstance(path[0], bytes) else ""
            if name not in by_name:
                continue
            chunk_metas[by_name[name]] = {
                "codec": int(md.get(4, 0)),
                "num_values": int(md.get(5, 0)),
                "data_page_offset": int(md.get(9, 0)),
                "dict_page_offset": int(md[11]) if 11 in md else None,
                "total_compressed_size": int(md.get(7, 0)),
            }
        if any(m is None for m in chunk_metas):
            raise ParquetError("row group missing column chunk")
        row_groups.append(chunk_metas)  # type: ignore[arg-type]
    return ParquetFile(columns=cols, num_rows=int(fmd.get(3, 0)), row_groups=row_groups)


# ---------------------------------------------------------------------------
# Level + value decoding
# ---------------------------------------------------------------------------


def _read_rle_bitpacked_hybrid(buf: bytes, pos: int, bit_width: int, count: int,
                               length: int | None = None) -> tuple[list[int], int]:
    """RLE/bit-packed hybrid run decoder (spec 'RLE' encoding)."""
    out: list[int] = []
    if bit_width == 0:
        return [0] * count, pos
    if length is None:
        length = int.from_bytes(buf[pos : pos + 4], "little")
        pos += 4
    end = pos + length
    byte_width = (bit_width + 7) // 8
    while pos < end and len(out) < count:
        header = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        if header & 1:  # bit-packed: (header>>1) groups of 8
            n_groups = header >> 1
            n_vals = n_groups * 8
            bits = int.from_bytes(buf[pos : pos + n_groups * bit_width], "little")
            pos += n_groups * bit_width
            mask = (1 << bit_width) - 1
            for k in range(n_vals):
                if len(out) >= count:
                    break
                out.append((bits >> (k * bit_width)) & mask)
        else:  # RLE run
            run = header >> 1
            v = int.from_bytes(buf[pos : pos + byte_width], "little")
            pos += byte_width
            out.extend([v] * min(run, count - len(out)))
    return out[:count], end


def _decode_plain(ptype: int, buf: bytes, pos: int, count: int) -> list:
    out: list = []
    if ptype == BOOLEAN:
        for k in range(count):
            out.append(bool((buf[pos + k // 8] >> (k % 8)) & 1))
        return out
    if ptype == INT32:
        return list(struct.unpack_from(f"<{count}i", buf, pos))
    if ptype == INT64:
        return list(struct.unpack_from(f"<{count}q", buf, pos))
    if ptype == FLOAT:
        return list(struct.unpack_from(f"<{count}f", buf, pos))
    if ptype == DOUBLE:
        return list(struct.unpack_from(f"<{count}d", buf, pos))
    if ptype == BYTE_ARRAY:
        for _ in range(count):
            n = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
            out.append(buf[pos : pos + n])
            pos += n
        return out
    if ptype == INT96:
        for _ in range(count):
            out.append(int.from_bytes(buf[pos : pos + 12], "little"))
            pos += 12
        return out
    raise ParquetError(f"unsupported physical type {ptype}")


def _convert(col: Column, v):
    if v is None:
        return None
    # ConvertedType: 0=UTF8, 6=DATE, 9/10=TIMESTAMP_(MILLIS|MICROS).
    if col.physical_type == BYTE_ARRAY:
        if col.converted_type == 0:  # UTF8
            return v.decode("utf-8", "replace")
        try:
            return v.decode("utf-8")
        except UnicodeDecodeError:
            return v
    if col.converted_type == 6 and isinstance(v, int):  # DATE: days since epoch
        import datetime

        return (datetime.date(1970, 1, 1) + datetime.timedelta(days=v)).isoformat()
    if col.converted_type in (9, 10) and isinstance(v, int):  # TIMESTAMP
        import datetime

        div = 1_000 if col.converted_type == 9 else 1_000_000
        dt = datetime.datetime.fromtimestamp(v / div, tz=datetime.timezone.utc)
        return dt.strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    return v


def _read_column_chunk(data: bytes, col: Column, meta: dict) -> list:
    """All values of one column chunk, Nones for null slots."""
    codec = meta["codec"]
    values: list = []
    dictionary: list | None = None
    pos = meta["dict_page_offset"] if meta["dict_page_offset"] is not None else meta["data_page_offset"]
    # Guard against writers that put the dict page after data pages offset-wise.
    if meta["dict_page_offset"] is not None and meta["dict_page_offset"] > meta["data_page_offset"]:
        pos = meta["data_page_offset"]
    remaining = meta["num_values"]
    while remaining > 0:
        tr = ThriftReader(data, pos)
        ph = tr.read_struct()
        pos = tr.pos
        # PageHeader: 1=type 2=uncompressed_size 3=compressed_size
        ptype_page = int(ph.get(1, PAGE_DATA))
        comp_size = int(ph.get(3, 0))
        uncomp_size = int(ph.get(2, 0))
        raw = data[pos : pos + comp_size]
        pos += comp_size
        if ptype_page == PAGE_DICTIONARY:
            page = _decompress(codec, raw, uncomp_size)
            # DictionaryPageHeader (field 7): 1=num_values
            dph = ph.get(7, {})
            n = int(dph.get(1, 0)) if isinstance(dph, dict) else 0
            dictionary = _decode_plain(col.physical_type, page, 0, n)
            continue
        if ptype_page == PAGE_DATA:
            page = _decompress(codec, raw, uncomp_size)
            # DataPageHeader (field 5): 1=num_values 2=encoding
            dh = ph.get(5, {})
            n = int(dh.get(1, 0))
            enc = int(dh.get(2, ENC_PLAIN))
            p = 0
            if col.max_def_level > 0:
                defs, p = _read_rle_bitpacked_hybrid(page, p, 1, n)
            else:
                defs = [1] * n
            present = sum(defs)
            vals = _decode_page_values(col, enc, dictionary, page, p, present)
            values.extend(_merge_nulls(defs, vals))
            remaining -= n
            continue
        if ptype_page == PAGE_DATA_V2:
            # DataPageHeaderV2 (field 8): 1=num_values 2=num_nulls 3=num_rows
            # 4=encoding 5=def_levels_byte_length 6=rep_levels_byte_length
            # 7=is_compressed
            dh = ph.get(8, {})
            n = int(dh.get(1, 0))
            enc = int(dh.get(4, ENC_PLAIN))
            dl_len = int(dh.get(5, 0))
            rl_len = int(dh.get(6, 0))
            compressed_flag = bool(dh.get(7, True))
            levels = raw[: dl_len + rl_len]
            body = raw[dl_len + rl_len :]
            if compressed_flag:
                body = _decompress(codec, body, uncomp_size - dl_len - rl_len)
            if rl_len:
                raise ParquetError("repeated fields are not supported by S3 Select")
            if col.max_def_level > 0 and dl_len:
                defs, _ = _read_rle_bitpacked_hybrid(levels, 0, 1, n, length=dl_len)
            else:
                defs = [1] * n
            present = sum(defs)
            vals = _decode_page_values(col, enc, dictionary, body, 0, present)
            values.extend(_merge_nulls(defs, vals))
            remaining -= n
            continue
        raise ParquetError(f"unsupported page type {ptype_page}")
    return [_convert(col, v) for v in values]


def _decode_page_values(col: Column, enc: int, dictionary: list | None,
                        page: bytes, p: int, count: int) -> list:
    if count == 0:
        return []
    if enc == ENC_PLAIN:
        return _decode_plain(col.physical_type, page, p, count)
    if enc in (ENC_PLAIN_DICTIONARY, ENC_RLE_DICTIONARY):
        if dictionary is None:
            raise ParquetError("dictionary-encoded page without dictionary")
        bit_width = page[p]
        idxs, _ = _read_rle_bitpacked_hybrid(
            page, p + 1, bit_width, count, length=len(page) - p - 1
        )
        return [dictionary[i] for i in idxs]
    raise ParquetError(f"unsupported encoding {enc}")


def _merge_nulls(defs: list[int], vals: list) -> list:
    if len(vals) == len(defs):
        return vals
    out = []
    it = iter(vals)
    for d in defs:
        out.append(next(it) if d else None)
    return out


# ---------------------------------------------------------------------------
# Row iteration (the S3 Select reader surface)
# ---------------------------------------------------------------------------


def read_rows(data: bytes) -> tuple[list[str], list[dict]]:
    """Parse a whole parquet blob -> (column names, rows as dicts)."""
    pf = parse_metadata(data)
    names = [c.name for c in pf.columns]
    rows: list[dict] = []
    for chunk_metas in pf.row_groups:
        cols_values = [
            _read_column_chunk(data, col, meta)
            for col, meta in zip(pf.columns, chunk_metas)
        ]
        n = max((len(v) for v in cols_values), default=0)
        for i in range(n):
            rows.append(
                {
                    name: (vals[i] if i < len(vals) else None)
                    for name, vals in zip(names, cols_values)
                }
            )
    return names, rows
