"""Dynamic value semantics for S3 Select SQL.

Equivalent of the reference's ``internal/s3select/sql/value.go`` (Value type
with lazy numeric inference: CSV fields arrive as strings and are coerced when
compared/combined with numeric operands).
"""

from __future__ import annotations

import datetime as _dt
from typing import Any

MISSING = object()  # distinct from SQL NULL: column absent from the record


class SelectValueError(Exception):
    """Type error during expression evaluation (maps to an S3 error code)."""


def is_null(v: Any) -> bool:
    return v is None


def is_missing(v: Any) -> bool:
    return v is MISSING


def _try_number(s: str):
    t = s.strip()
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        return None


def to_number(v: Any):
    """Coerce to int/float or raise."""
    if isinstance(v, bool):
        raise SelectValueError("cannot use boolean as number")
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        n = _try_number(v)
        if n is not None:
            return n
    raise SelectValueError(f"cannot convert {type(v).__name__} to number")


def to_bool(v: Any):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        t = v.strip().lower()
        if t == "true":
            return True
        if t == "false":
            return False
    raise SelectValueError(f"cannot convert {type(v).__name__} to bool")


def to_string(v: Any) -> str:
    if v is None or v is MISSING:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        # Render floats the way the reference does: no trailing .0 for integral
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    if isinstance(v, _dt.datetime):
        return format_timestamp(v)
    return str(v)


def compare(a: Any, b: Any, op: str) -> Any:
    """Three-valued comparison; returns bool or None (SQL NULL)."""
    if a is None or b is None or a is MISSING or b is MISSING:
        return None
    # Timestamp comparisons
    if isinstance(a, _dt.datetime) or isinstance(b, _dt.datetime):
        if not (isinstance(a, _dt.datetime) and isinstance(b, _dt.datetime)):
            raise SelectValueError("cannot compare timestamp with non-timestamp")
        return _cmp(a, b, op)
    # Boolean comparisons: only = / != meaningful
    if isinstance(a, bool) or isinstance(b, bool):
        try:
            ab, bb = to_bool(a), to_bool(b)
        except SelectValueError:
            return False if op in ("=", "==") else (True if op in ("!=", "<>") else None)
        return _cmp(ab, bb, op)
    # If either side is numeric, coerce both to numbers
    if isinstance(a, (int, float)) or isinstance(b, (int, float)):
        try:
            return _cmp(to_number(a), to_number(b), op)
        except SelectValueError:
            # numeric vs non-numeric string: unequal
            if op in ("=", "=="):
                return False
            if op in ("!=", "<>"):
                return True
            raise
    # Both strings
    return _cmp(str(a), str(b), op)


def _cmp(a, b, op: str) -> bool:
    if op in ("=", "=="):
        return a == b
    if op in ("!=", "<>"):
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise SelectValueError(f"unknown comparison operator {op}")


def arith(a: Any, b: Any, op: str) -> Any:
    if a is None or b is None or a is MISSING or b is MISSING:
        return None
    x, y = to_number(a), to_number(b)
    if op == "+":
        return x + y
    if op == "-":
        return x - y
    if op == "*":
        return x * y
    if op == "/":
        if y == 0:
            raise SelectValueError("division by zero")
        if isinstance(x, int) and isinstance(y, int):
            # integer division truncates toward zero (SQL semantics)
            q = abs(x) // abs(y)
            return q if (x >= 0) == (y >= 0) else -q
        return x / y
    if op == "%":
        if y == 0:
            raise SelectValueError("modulo by zero")
        if isinstance(x, int) and isinstance(y, int):
            return x - y * (abs(x) // abs(y)) * (1 if (x >= 0) == (y >= 0) else -1)
        raise SelectValueError("modulo requires integer operands")
    raise SelectValueError(f"unknown arithmetic operator {op}")


# ---------------------------------------------------------------- timestamps

# Subset of the partiql/Ion timestamp format patterns used by TO_STRING
# (reference: sql/timestampfuncs.go).
_FMT_MAP = [
    ("yyyy", "%Y"),
    ("MM", "%m"),
    ("dd", "%d"),
    ("HH", "%H"),
    ("hh", "%I"),
    ("mm", "%M"),
    ("ss", "%S"),
    ("y", "%Y"),
    ("M", "%m"),
    ("d", "%d"),
    ("H", "%H"),
    ("h", "%I"),
    ("m", "%M"),
    ("s", "%S"),
    ("a", "%p"),
]


def parse_timestamp(s: str) -> _dt.datetime:
    t = s.strip()
    for fmt in (
        "%Y-%m-%dT%H:%M:%S.%f%z",
        "%Y-%m-%dT%H:%M:%S%z",
        "%Y-%m-%dT%H:%M%z",
        "%Y-%m-%dT%H:%M:%S.%f",
        "%Y-%m-%dT%H:%M:%S",
        "%Y-%m-%dT%H:%M",
        "%Y-%m-%d",
        "%Y-%m",
        "%Y",
    ):
        try:
            ts = _dt.datetime.strptime(t.replace("Z", "+00:00") if fmt.endswith("%z") else t, fmt)
            if ts.tzinfo is None:
                ts = ts.replace(tzinfo=_dt.timezone.utc)
            return ts
        except ValueError:
            continue
    raise SelectValueError(f"cannot parse timestamp {s!r}")


def format_timestamp(ts: _dt.datetime, pattern: str | None = None) -> str:
    if pattern is None:
        out = ts.strftime("%Y-%m-%dT%H:%M:%S")
        if ts.microsecond:
            out += "." + f"{ts.microsecond:06d}".rstrip("0")
        off = ts.utcoffset()
        if off is None or off == _dt.timedelta(0):
            out += "Z"
        else:
            total = int(off.total_seconds())
            sign = "+" if total >= 0 else "-"
            total = abs(total)
            out += f"{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"
        return out
    # translate pattern (longest tokens first, already ordered in _FMT_MAP)
    out = []
    i = 0
    while i < len(pattern):
        for tok, strf in _FMT_MAP:
            if pattern.startswith(tok, i):
                out.append(ts.strftime(strf))
                i += len(tok)
                break
        else:
            out.append(pattern[i])
            i += 1
    return "".join(out)
