"""SQL parser for the S3 Select dialect.

Hand-rolled tokenizer + recursive-descent parser (the reference builds its
grammar with participle — ``internal/s3select/sql/parser.go``). Produces a
small AST consumed by :mod:`minio_tpu_torch.s3select.eval`.

Grammar (S3 Select subset):

    select_stmt := SELECT projections FROM table [WHERE expr] [LIMIT int]
    projections := '*' | expr [AS alias] (',' expr [AS alias])*
    table       := path [AS? alias]          -- path like S3Object[*].a[*].b
    expr        := or_expr
    or_expr     := and_expr (OR and_expr)*
    and_expr    := not_expr (AND not_expr)*
    not_expr    := [NOT] cond_expr
    cond_expr   := add_expr [comparison | BETWEEN | IN | LIKE | IS ...]
    add_expr    := mul_expr (('+'|'-'|'||') mul_expr)*
    mul_expr    := unary (('*'|'/'|'%') unary)*
    unary       := ['-'|'+'] primary
    primary     := literal | function | identifier-path | '(' expr ')'
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


class SQLParseError(Exception):
    pass


# ------------------------------------------------------------------ tokens

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><>|!=|<=|>=|\|\||==|[-+*/%(),.=<>\[\]])
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "LIMIT", "AS", "AND", "OR", "NOT", "BETWEEN",
    "IN", "LIKE", "ESCAPE", "IS", "NULL", "MISSING", "TRUE", "FALSE", "CAST",
}


@dataclass
class Token:
    kind: str  # number | string | ident | qident | op | star | end
    value: Any
    pos: int


def tokenize(s: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if not m:
            raise SQLParseError(f"unexpected character {s[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "number":
            if re.fullmatch(r"\d+", text):
                out.append(Token("number", int(text), m.start()))
            else:
                out.append(Token("number", float(text), m.start()))
        elif kind == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"), m.start()))
        elif kind == "qident":
            out.append(Token("qident", text[1:-1].replace('""', '"'), m.start()))
        elif kind == "ident":
            out.append(Token("ident", text, m.start()))
        else:
            out.append(Token("op", text, m.start()))
    out.append(Token("end", None, len(s)))
    return out


# --------------------------------------------------------------------- AST


@dataclass
class Literal:
    value: Any


@dataclass
class PathExpr:
    """Column / JSON-path reference: steps after optional alias root.

    steps: list of ("key", name) | ("index", i) | ("wildcard", None)
    raw: the source text for output-column naming.
    """
    steps: List[Tuple[str, Any]]
    raw: str
    quoted_head: bool = False  # head came from a "quoted" identifier


@dataclass
class Unary:
    op: str
    operand: Any


@dataclass
class Binary:
    op: str
    left: Any
    right: Any


@dataclass
class Compare:
    op: str
    left: Any
    right: Any


@dataclass
class And:
    parts: List[Any]


@dataclass
class Or:
    parts: List[Any]


@dataclass
class Not:
    operand: Any


@dataclass
class Between:
    operand: Any
    lo: Any
    hi: Any
    negated: bool = False


@dataclass
class In:
    operand: Any
    choices: List[Any]
    negated: bool = False


@dataclass
class Like:
    operand: Any
    pattern: Any
    escape: Optional[Any] = None
    negated: bool = False


@dataclass
class IsNull:
    operand: Any
    negated: bool = False


@dataclass
class IsMissing:
    operand: Any
    negated: bool = False


@dataclass
class FuncCall:
    name: str
    args: List[Any] = field(default_factory=list)
    # special payloads for irregular syntaxes
    extra: dict = field(default_factory=dict)


@dataclass
class Star:
    pass


@dataclass
class Projection:
    expr: Any
    alias: Optional[str] = None


@dataclass
class SelectStatement:
    projections: List[Projection]  # [Projection(Star())] for SELECT *
    table_path: List[Tuple[str, Any]]  # steps after S3Object root
    table_alias: Optional[str]
    where: Optional[Any]
    limit: Optional[int]


AGGREGATES = {"COUNT", "SUM", "AVG", "MIN", "MAX"}

FUNCTIONS = {
    "CAST", "COALESCE", "NULLIF", "CHAR_LENGTH", "CHARACTER_LENGTH", "LOWER",
    "UPPER", "TRIM", "SUBSTRING", "UTCNOW", "TO_STRING", "TO_TIMESTAMP",
    "DATE_ADD", "DATE_DIFF", "EXTRACT",
} | AGGREGATES


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # ---- token helpers

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def kw(self, *words: str) -> bool:
        """Consume the keyword if next token matches (case-insensitive)."""
        t = self.peek()
        if t.kind == "ident" and t.value.upper() in words:
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.kw(word):
            raise SQLParseError(f"expected {word} near position {self.peek().pos}")

    def op(self, *ops: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            self.next()
            return t.value
        return None

    def expect_op(self, o: str) -> None:
        if not self.op(o):
            raise SQLParseError(f"expected {o!r} near position {self.peek().pos}")

    # ---- grammar

    def parse(self) -> SelectStatement:
        self.expect_kw("SELECT")
        projections = self.parse_projections()
        self.expect_kw("FROM")
        table_path, alias = self.parse_table()
        where = None
        if self.kw("WHERE"):
            where = self.parse_expr()
        limit = None
        if self.kw("LIMIT"):
            t = self.next()
            if t.kind != "number" or not isinstance(t.value, int) or t.value < 0:
                raise SQLParseError("LIMIT must be a non-negative integer")
            limit = t.value
        if self.peek().kind != "end":
            raise SQLParseError(f"unexpected trailing input at {self.peek().pos}")
        return SelectStatement(projections, table_path, alias, where, limit)

    def parse_projections(self) -> List[Projection]:
        if self.op("*"):
            return [Projection(Star())]
        out = [self.parse_projection()]
        while self.op(","):
            out.append(self.parse_projection())
        return out

    def parse_projection(self) -> Projection:
        expr = self.parse_expr()
        alias = None
        if self.kw("AS"):
            t = self.next()
            if t.kind not in ("ident", "qident"):
                raise SQLParseError("expected alias after AS")
            alias = t.value
        return Projection(expr, alias)

    def parse_table(self) -> Tuple[List[Tuple[str, Any]], Optional[str]]:
        t = self.next()
        if t.kind not in ("ident", "qident") or t.value.upper() != "S3OBJECT":
            raise SQLParseError("FROM clause must reference S3Object")
        steps = self.parse_path_steps()
        alias = None
        if self.kw("AS"):
            t = self.next()
            if t.kind not in ("ident", "qident"):
                raise SQLParseError("expected table alias")
            alias = t.value
        else:
            t = self.peek()
            if t.kind in ("ident", "qident") and (
                t.kind == "qident" or t.value.upper() not in KEYWORDS
            ):
                alias = self.next().value
        return steps, alias

    def parse_path_steps(self) -> List[Tuple[str, Any]]:
        steps: List[Tuple[str, Any]] = []
        while True:
            if self.op("."):
                t = self.next()
                if t.kind not in ("ident", "qident"):
                    raise SQLParseError("expected identifier after '.'")
                steps.append(("key", t.value))
            elif self.op("["):
                if self.op("*"):
                    steps.append(("wildcard", None))
                else:
                    t = self.next()
                    if t.kind == "number" and isinstance(t.value, int):
                        steps.append(("index", t.value))
                    elif t.kind == "string":
                        steps.append(("key", t.value))
                    else:
                        raise SQLParseError("expected index, '*' or 'key' inside []")
                self.expect_op("]")
            else:
                return steps

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        parts = [self.parse_and()]
        while self.kw("OR"):
            parts.append(self.parse_and())
        return parts[0] if len(parts) == 1 else Or(parts)

    def parse_and(self):
        parts = [self.parse_not()]
        while self.kw("AND"):
            parts.append(self.parse_not())
        return parts[0] if len(parts) == 1 else And(parts)

    def parse_not(self):
        if self.kw("NOT"):
            return Not(self.parse_not())
        return self.parse_cond()

    def parse_cond(self):
        left = self.parse_add()
        o = self.op("=", "==", "!=", "<>", "<", "<=", ">", ">=")
        if o:
            right = self.parse_add()
            return Compare(o, left, right)
        negated = False
        if self.kw("NOT"):
            negated = True
        if self.kw("BETWEEN"):
            lo = self.parse_add()
            self.expect_kw("AND")
            hi = self.parse_add()
            return Between(left, lo, hi, negated)
        if self.kw("IN"):
            self.expect_op("(")
            choices = [self.parse_expr()]
            while self.op(","):
                choices.append(self.parse_expr())
            self.expect_op(")")
            return In(left, choices, negated)
        if self.kw("LIKE"):
            pattern = self.parse_add()
            escape = None
            if self.kw("ESCAPE"):
                escape = self.parse_add()
            return Like(left, pattern, escape, negated)
        if negated:
            raise SQLParseError("expected BETWEEN/IN/LIKE after NOT")
        if self.kw("IS"):
            neg = bool(self.kw("NOT"))
            if self.kw("NULL"):
                return IsNull(left, neg)
            if self.kw("MISSING"):
                return IsMissing(left, neg)
            raise SQLParseError("expected NULL or MISSING after IS")
        return left

    def parse_add(self):
        left = self.parse_mul()
        while True:
            o = self.op("+", "-", "||")
            if not o:
                return left
            left = Binary(o, left, self.parse_mul())

    def parse_mul(self):
        left = self.parse_unary()
        while True:
            o = self.op("*", "/", "%")
            if not o:
                return left
            left = Binary(o, left, self.parse_unary())

    def parse_unary(self):
        o = self.op("-", "+")
        if o:
            return Unary(o, self.parse_unary())
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if t.kind == "number" or t.kind == "string":
            self.next()
            return Literal(t.value)
        if t.kind == "op" and t.value == "(":
            self.next()
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "qident":
            self.next()
            steps = [("key", t.value)] + self.parse_path_steps()
            return PathExpr(steps, t.value, quoted_head=True)
        if t.kind == "ident":
            upper = t.value.upper()
            if upper == "TRUE":
                self.next()
                return Literal(True)
            if upper == "FALSE":
                self.next()
                return Literal(False)
            if upper == "NULL":
                self.next()
                return Literal(None)
            # function call?
            nxt = self.toks[self.i + 1]
            if upper in FUNCTIONS and nxt.kind == "op" and nxt.value == "(":
                return self.parse_function()
            self.next()
            steps = [("key", t.value)] + self.parse_path_steps()
            return PathExpr(steps, t.value)
        raise SQLParseError(f"unexpected token near position {t.pos}")

    def parse_function(self):
        name = self.next().value.upper()
        self.expect_op("(")
        if name == "CAST":
            expr = self.parse_expr()
            self.expect_kw("AS")
            t = self.next()
            if t.kind != "ident":
                raise SQLParseError("expected type name in CAST")
            self.expect_op(")")
            return FuncCall("CAST", [expr], {"type": t.value.upper()})
        if name == "EXTRACT":
            t = self.next()
            if t.kind != "ident":
                raise SQLParseError("expected date part in EXTRACT")
            self.expect_kw("FROM")
            expr = self.parse_expr()
            self.expect_op(")")
            return FuncCall("EXTRACT", [expr], {"part": t.value.upper()})
        if name in ("DATE_ADD", "DATE_DIFF"):
            t = self.next()
            if t.kind != "ident":
                raise SQLParseError(f"expected date part in {name}")
            self.expect_op(",")
            a = self.parse_expr()
            self.expect_op(",")
            b = self.parse_expr()
            self.expect_op(")")
            return FuncCall(name, [a, b], {"part": t.value.upper()})
        if name == "SUBSTRING":
            expr = self.parse_expr()
            if self.kw("FROM"):
                start = self.parse_expr()
                length = None
                if self.kw("FOR"):
                    length = self.parse_expr()
                self.expect_op(")")
                args = [expr, start] + ([length] if length is not None else [])
                return FuncCall("SUBSTRING", args)
            args = [expr]
            while self.op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return FuncCall("SUBSTRING", args)
        if name == "TRIM":
            # TRIM([LEADING|TRAILING|BOTH] [chars] FROM str) | TRIM(str)
            mode = "BOTH"
            chars = None
            t = self.peek()
            if t.kind == "ident" and t.value.upper() in ("LEADING", "TRAILING", "BOTH"):
                mode = t.value.upper()
                self.next()
                if not self.kw("FROM"):
                    chars = self.parse_expr()
                    self.expect_kw("FROM")
                target = self.parse_expr()
                self.expect_op(")")
                return FuncCall("TRIM", [target], {"mode": mode, "chars": chars})
            first = self.parse_expr()
            if self.kw("FROM"):
                target = self.parse_expr()
                self.expect_op(")")
                return FuncCall("TRIM", [target], {"mode": mode, "chars": first})
            self.expect_op(")")
            return FuncCall("TRIM", [first], {"mode": mode, "chars": None})
        if name == "COUNT":
            if self.op("*"):
                self.expect_op(")")
                return FuncCall("COUNT", [Star()])
            expr = self.parse_expr()
            self.expect_op(")")
            return FuncCall("COUNT", [expr])
        # generic argument list
        args = []
        if not self.op(")"):
            args.append(self.parse_expr())
            while self.op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
        return FuncCall(name, args)


def parse(sql: str) -> SelectStatement:
    return Parser(sql).parse()


def has_aggregates(node: Any) -> bool:
    if isinstance(node, FuncCall):
        if node.name in AGGREGATES:
            return True
        return any(has_aggregates(a) for a in node.args)
    if isinstance(node, (Unary, Not)):
        return has_aggregates(node.operand)
    if isinstance(node, (Binary, Compare)):
        return has_aggregates(node.left) or has_aggregates(node.right)
    if isinstance(node, (And, Or)):
        return any(has_aggregates(p) for p in node.parts)
    if isinstance(node, Between):
        return any(has_aggregates(x) for x in (node.operand, node.lo, node.hi))
    if isinstance(node, In):
        return has_aggregates(node.operand) or any(has_aggregates(c) for c in node.choices)
    if isinstance(node, Like):
        return has_aggregates(node.operand) or has_aggregates(node.pattern)
    if isinstance(node, (IsNull, IsMissing)):
        return has_aggregates(node.operand)
    if isinstance(node, Projection):
        return has_aggregates(node.expr)
    return False
