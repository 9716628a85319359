"""Expression evaluator + aggregation engine for S3 Select SQL.

Equivalent of the reference's ``internal/s3select/sql/{evaluate,aggregation,
funceval,statement}.go``. Rows stream through :class:`StatementExecutor`;
aggregate queries accumulate state and emit one final row.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Any, Dict, List, Optional

from . import sql as ast
from .records import CSVRecord, JSONRecord
from .value import (
    MISSING,
    SelectValueError,
    arith,
    compare,
    format_timestamp,
    parse_timestamp,
    to_bool,
    to_number,
    to_string,
)


class SelectEvalError(Exception):
    pass


_DATE_PARTS = {"YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "TIMEZONE_HOUR", "TIMEZONE_MINUTE"}


def _truthy(v: Any) -> bool:
    """WHERE-clause truthiness: NULL/MISSING are false."""
    if v is None or v is MISSING:
        return False
    if isinstance(v, bool):
        return v
    try:
        return to_bool(v)
    except SelectValueError:
        raise SelectEvalError("WHERE clause did not evaluate to a boolean")


def _like_to_regex(pattern: str, escape: Optional[str]) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


class _AggState:
    __slots__ = ("count", "total", "min", "max", "seen")

    def __init__(self):
        self.count = 0
        self.total = 0
        self.min = None
        self.max = None
        self.seen = False


class Evaluator:
    """Evaluates AST nodes against one record; owns aggregate state keyed by node id."""

    def __init__(self, table_alias: Optional[str]):
        self.table_alias = table_alias
        self.agg: Dict[int, _AggState] = {}
        self.aggregating = False  # True during the accumulation pass

    # ---------------------------------------------------------------- paths

    def _resolve_path(self, node: ast.PathExpr, record) -> Any:
        steps = list(node.steps)
        # strip leading table alias (case-insensitive unless quoted)
        if steps and steps[0][0] == "key":
            head = steps[0][1]
            if self.table_alias and head.lower() == self.table_alias.lower():
                steps = steps[1:]
            elif head.upper() == "S3OBJECT":
                steps = steps[1:]
        if not steps:
            return record.as_dict() if isinstance(record, JSONRecord) else MISSING
        first_kind, first_val = steps[0]
        if first_kind != "key":
            raise SelectEvalError("path must start with an identifier")
        cur = record.get(first_val)
        for kind, val in steps[1:]:
            cur = self._step(cur, kind, val)
            if cur is MISSING:
                return MISSING
        return cur

    def _step(self, cur: Any, kind: str, val: Any) -> Any:
        if cur is MISSING or cur is None:
            return MISSING
        if kind == "key":
            if isinstance(cur, dict):
                if val in cur:
                    return cur[val]
                for k, v in cur.items():
                    if k.lower() == str(val).lower():
                        return v
                return MISSING
            if isinstance(cur, list):
                # map over list elements (wildcard-ish projection)
                out = [self._step(e, kind, val) for e in cur]
                return [o for o in out if o is not MISSING]
            return MISSING
        if kind == "index":
            if isinstance(cur, list):
                if 0 <= val < len(cur):
                    return cur[val]
                return MISSING
            return MISSING
        if kind == "wildcard":
            if isinstance(cur, list):
                return cur
            if isinstance(cur, dict):
                return list(cur.values())
            return MISSING
        raise SelectEvalError(f"unknown path step {kind}")

    # ----------------------------------------------------------------- eval

    def eval(self, node: Any, record) -> Any:
        if isinstance(node, ast.Literal):
            return node.value
        if isinstance(node, ast.PathExpr):
            return self._resolve_path(node, record)
        if isinstance(node, ast.Unary):
            v = self.eval(node.operand, record)
            if v is None or v is MISSING:
                return None
            n = to_number(v)
            return -n if node.op == "-" else n
        if isinstance(node, ast.Binary):
            if node.op == "||":
                a = self.eval(node.left, record)
                b = self.eval(node.right, record)
                if a is None or b is None or a is MISSING or b is MISSING:
                    return None
                return to_string(a) + to_string(b)
            return arith(self.eval(node.left, record), self.eval(node.right, record), node.op)
        if isinstance(node, ast.Compare):
            return compare(self.eval(node.left, record), self.eval(node.right, record), node.op)
        if isinstance(node, ast.And):
            result: Any = True
            for p in node.parts:
                v = self.eval(p, record)
                if v is None or v is MISSING:
                    result = None
                    continue
                if not _truthy(v):
                    return False
            return result
        if isinstance(node, ast.Or):
            result: Any = False
            for p in node.parts:
                v = self.eval(p, record)
                if v is None or v is MISSING:
                    result = None
                    continue
                if _truthy(v):
                    return True
            return result
        if isinstance(node, ast.Not):
            v = self.eval(node.operand, record)
            if v is None or v is MISSING:
                return None
            return not _truthy(v)
        if isinstance(node, ast.Between):
            v = self.eval(node.operand, record)
            lo = self.eval(node.lo, record)
            hi = self.eval(node.hi, record)
            a = compare(v, lo, ">=")
            b = compare(v, hi, "<=")
            if a is None or b is None:
                return None
            r = a and b
            return (not r) if node.negated else r
        if isinstance(node, ast.In):
            v = self.eval(node.operand, record)
            if v is None or v is MISSING:
                return None
            found = False
            saw_null = False
            for c in node.choices:
                cv = self.eval(c, record)
                r = compare(v, cv, "=")
                if r is None:
                    saw_null = True
                elif r:
                    found = True
                    break
            if found:
                return not node.negated
            if saw_null:
                return None
            return node.negated
        if isinstance(node, ast.Like):
            v = self.eval(node.operand, record)
            p = self.eval(node.pattern, record)
            if v is None or p is None or v is MISSING or p is MISSING:
                return None
            esc = None
            if node.escape is not None:
                e = self.eval(node.escape, record)
                esc = to_string(e)
                if len(esc) != 1:
                    raise SelectEvalError("ESCAPE must be a single character")
            r = bool(_like_to_regex(to_string(p), esc).match(to_string(v)))
            return (not r) if node.negated else r
        if isinstance(node, ast.IsNull):
            r = (self.eval(node.operand, record) is None)
            return (not r) if node.negated else r
        if isinstance(node, ast.IsMissing):
            r = (self.eval(node.operand, record) is MISSING)
            return (not r) if node.negated else r
        if isinstance(node, ast.FuncCall):
            return self.eval_func(node, record)
        if isinstance(node, ast.Star):
            raise SelectEvalError("'*' not valid here")
        raise SelectEvalError(f"cannot evaluate {type(node).__name__}")

    # ------------------------------------------------------------ functions

    def eval_func(self, node: ast.FuncCall, record) -> Any:
        name = node.name
        if name in ast.AGGREGATES:
            return self._eval_aggregate(node, record)
        if name == "CAST":
            return self._cast(self.eval(node.args[0], record), node.extra["type"])
        if name == "COALESCE":
            for a in node.args:
                v = self.eval(a, record)
                if v is not None and v is not MISSING:
                    return v
            return None
        if name == "NULLIF":
            a = self.eval(node.args[0], record)
            b = self.eval(node.args[1], record)
            if compare(a, b, "=") is True:
                return None
            return a
        if name in ("CHAR_LENGTH", "CHARACTER_LENGTH"):
            v = self.eval(node.args[0], record)
            if v is None or v is MISSING:
                return None
            return len(to_string(v))
        if name == "LOWER":
            v = self.eval(node.args[0], record)
            return None if v is None or v is MISSING else to_string(v).lower()
        if name == "UPPER":
            v = self.eval(node.args[0], record)
            return None if v is None or v is MISSING else to_string(v).upper()
        if name == "TRIM":
            v = self.eval(node.args[0], record)
            if v is None or v is MISSING:
                return None
            s = to_string(v)
            chars_expr = node.extra.get("chars")
            chars = " " if chars_expr is None else to_string(self.eval(chars_expr, record))
            mode = node.extra.get("mode", "BOTH")
            if mode in ("BOTH", "LEADING"):
                s = s.lstrip(chars)
            if mode in ("BOTH", "TRAILING"):
                s = s.rstrip(chars)
            return s
        if name == "SUBSTRING":
            v = self.eval(node.args[0], record)
            if v is None or v is MISSING:
                return None
            s = to_string(v)
            start = int(to_number(self.eval(node.args[1], record)))
            length = None
            if len(node.args) > 2:
                length = int(to_number(self.eval(node.args[2], record)))
                if length < 0:
                    raise SelectEvalError("negative substring length")
            # SQL 1-based semantics; start may be <= 0
            end = None if length is None else start + length
            begin = max(start, 1)
            if end is not None and end <= 1:
                return ""
            py_start = begin - 1
            py_end = None if end is None else end - 1
            return s[py_start:py_end]
        if name == "UTCNOW":
            return _dt.datetime.now(_dt.timezone.utc).replace(microsecond=0)
        if name == "TO_STRING":
            v = self.eval(node.args[0], record)
            if v is None or v is MISSING:
                return None
            if not isinstance(v, _dt.datetime):
                raise SelectEvalError("TO_STRING expects a timestamp")
            fmt = to_string(self.eval(node.args[1], record)) if len(node.args) > 1 else None
            return format_timestamp(v, fmt)
        if name == "TO_TIMESTAMP":
            v = self.eval(node.args[0], record)
            if v is None or v is MISSING:
                return None
            if isinstance(v, _dt.datetime):
                return v
            return parse_timestamp(to_string(v))
        if name in ("DATE_ADD", "DATE_DIFF"):
            part = node.extra["part"]
            if part not in _DATE_PARTS:
                raise SelectEvalError(f"unknown date part {part}")
            if name == "DATE_ADD":
                qty = int(to_number(self.eval(node.args[0], record)))
                ts = self._want_ts(self.eval(node.args[1], record))
                return _date_add(part, qty, ts)
            ts1 = self._want_ts(self.eval(node.args[0], record))
            ts2 = self._want_ts(self.eval(node.args[1], record))
            return _date_diff(part, ts1, ts2)
        if name == "EXTRACT":
            part = node.extra["part"]
            ts = self._want_ts(self.eval(node.args[0], record))
            return _extract(part, ts)
        raise SelectEvalError(f"unknown function {name}")

    @staticmethod
    def _want_ts(v: Any) -> _dt.datetime:
        if isinstance(v, _dt.datetime):
            return v
        if isinstance(v, str):
            return parse_timestamp(v)
        raise SelectEvalError("expected a timestamp value")

    @staticmethod
    def _cast(v: Any, typ: str) -> Any:
        if v is None or v is MISSING:
            return None
        try:
            if typ in ("INT", "INTEGER"):
                if isinstance(v, str):
                    return int(float(v)) if "." in v or "e" in v.lower() else int(v)
                return int(to_number(v))
            if typ in ("FLOAT", "DECIMAL", "NUMERIC", "DOUBLE"):
                return float(to_number(v))
            if typ in ("STRING", "CHAR", "VARCHAR"):
                return to_string(v)
            if typ in ("BOOL", "BOOLEAN"):
                return to_bool(v)
            if typ == "TIMESTAMP":
                if isinstance(v, _dt.datetime):
                    return v
                return parse_timestamp(to_string(v))
        except (ValueError, SelectValueError) as e:
            raise SelectEvalError(f"CAST failed: {e}") from e
        raise SelectEvalError(f"unknown CAST target type {typ}")

    # ------------------------------------------------------------ aggregates

    def _eval_aggregate(self, node: ast.FuncCall, record) -> Any:
        st = self.agg.setdefault(id(node), _AggState())
        if self.aggregating:
            if node.name == "COUNT":
                if isinstance(node.args[0], ast.Star):
                    st.count += 1
                else:
                    v = self.eval(node.args[0], record)
                    if v is not None and v is not MISSING:
                        st.count += 1
                return None
            v = self.eval(node.args[0], record)
            if v is None or v is MISSING:
                return None
            if node.name in ("SUM", "AVG"):
                st.total += to_number(v)
                st.count += 1
                st.seen = True
            elif node.name == "MIN":
                if not st.seen or compare(v, st.min, "<"):
                    st.min = v
                st.seen = True
            elif node.name == "MAX":
                if not st.seen or compare(v, st.max, ">"):
                    st.max = v
                st.seen = True
            return None
        # final pass: read out accumulated state
        if node.name == "COUNT":
            return st.count
        if node.name == "SUM":
            return st.total if st.seen else None
        if node.name == "AVG":
            return (st.total / st.count) if st.seen and st.count else None
        if node.name == "MIN":
            return st.min if st.seen else None
        if node.name == "MAX":
            return st.max if st.seen else None
        raise SelectEvalError(f"unknown aggregate {node.name}")


class StatementExecutor:
    """Streams records through a parsed statement producing output rows.

    Output rows are ``(names, values)`` pairs ready for serialization.
    """

    def __init__(self, stmt: ast.SelectStatement):
        self.stmt = stmt
        self.ev = Evaluator(stmt.table_alias)
        self.is_aggregate = any(ast.has_aggregates(p) for p in stmt.projections)
        if self.is_aggregate:
            for p in stmt.projections:
                if not isinstance(p.expr, ast.Star) and not ast.has_aggregates(p.expr):
                    raise SelectEvalError(
                        "mixing aggregate and non-aggregate projections is not supported"
                    )
        self.emitted = 0
        self._names_cache: Optional[List[str]] = None

    def _projection_names(self, record) -> List[str]:
        names: List[str] = []
        for i, p in enumerate(self.stmt.projections):
            if p.alias:
                names.append(p.alias)
            elif isinstance(p.expr, ast.PathExpr):
                # last path component, like the reference's output naming
                last = p.expr.steps[-1]
                names.append(str(last[1]) if last[0] == "key" else f"_{i + 1}")
            else:
                names.append(f"_{i + 1}")
        return names

    def limit_reached(self) -> bool:
        return self.stmt.limit is not None and self.emitted >= self.stmt.limit

    def feed(self, record):
        """Process one input record. Yields 0 or 1 output rows (non-aggregate)."""
        if self.limit_reached():
            return
        # FROM-path flattening for JSON documents: S3Object[*].a[*] style
        sub_records = self._expand_from(record)
        for rec in sub_records:
            if self.limit_reached():
                return
            if self.stmt.where is not None:
                self.ev.aggregating = False
                v = self.ev.eval(self.stmt.where, rec)
                if not _truthy(v):
                    continue
            if self.is_aggregate:
                self.ev.aggregating = True
                for p in self.stmt.projections:
                    if not isinstance(p.expr, ast.Star):
                        self.ev.eval(p.expr, rec)
                self.ev.aggregating = False
                continue
            yield self._project(rec)
            self.emitted += 1

    def finish(self):
        """Emit the final aggregate row, if this is an aggregate query."""
        if not self.is_aggregate:
            return
        self.ev.aggregating = False
        names, values = [], []
        pnames = self._projection_names(None)
        for p, n in zip(self.stmt.projections, pnames):
            values.append(self.ev.eval(p.expr, JSONRecord({})))
            names.append(n)
        yield names, values

    def _expand_from(self, record) -> List[Any]:
        steps = self.stmt.table_path
        if not steps or not isinstance(record, JSONRecord):
            return [record]
        cur_list = [record.data]
        for kind, val in steps:
            nxt = []
            for cur in cur_list:
                if kind == "wildcard":
                    if isinstance(cur, list):
                        nxt.extend(cur)
                    elif cur is not None:
                        nxt.append(cur)
                elif kind == "key":
                    if isinstance(cur, dict) and val in cur:
                        nxt.append(cur[val])
                elif kind == "index":
                    if isinstance(cur, list) and 0 <= val < len(cur):
                        nxt.append(cur[val])
            cur_list = nxt
        return [JSONRecord(d) for d in cur_list]

    def _project(self, rec):
        projections = self.stmt.projections
        if len(projections) == 1 and isinstance(projections[0].expr, ast.Star):
            return rec.columns(), rec.star_values()
        names = self._projection_names(rec)
        values = []
        for p in projections:
            if isinstance(p.expr, ast.Star):
                raise SelectEvalError("'*' must be the only projection")
            values.append(self.ev.eval(p.expr, rec))
        return names, values
