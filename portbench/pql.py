"""A small parser for the PQL that the benchmark's traffic sends.

The reference and the least-bytes reckoning read the same query text as
the program under test, through this parser of their own: nothing of the
program parses for them. It knows the grammar the traffic files use:

    call  := NAME "(" [arg ("," arg)*] ")"
    arg   := call | NAME | NAME "=" (value | call) | [INT op] NAME op INT
    op    := "<" | "<=" | ">" | ">=" | "==" | "!="

A query is one or more calls one after another.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Tuple, Union

_TOKEN = re.compile(r"\s*(?:(<=|>=|==|!=|<|>)|(-?\d+)|([A-Za-z_][\w.\-]*)|"
                    r"(\"[^\"]*\")|([(),=]))")
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


@dataclass
class Call:
    """One call: its name, its bare names (as ``Rows(cab_type)`` has),
    its call arguments in order, its ``key=value`` arguments, and its
    comparisons as (field, op, value) with the field on the left."""
    name: str
    names: List[str] = field(default_factory=list)
    args: List["Call"] = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)
    conds: List[Tuple[str, str, int]] = field(default_factory=list)


def _tokens(text: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    text = text.strip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            raise ValueError(f"bad PQL at {pos}: {text[pos:pos + 20]!r}")
        kind = ("op", "int", "name", "str", "punct")[m.lastindex - 1]
        out.append((kind, m.group(m.lastindex)))
        pos = m.end()
        while pos < len(text) and text[pos].isspace():
            pos += 1
    return out


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokens(text)
        self.i = 0

    def peek(self, k: int = 0) -> Tuple[str, str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("end", "")

    def take(self, kind: str, value: str = None) -> str:
        tk, tv = self.peek()
        if tk != kind or (value is not None and tv != value):
            raise ValueError(f"expected {value or kind}, got {tv!r}")
        self.i += 1
        return tv

    def query(self) -> List[Call]:
        calls = []
        while self.peek()[0] != "end":
            calls.append(self.call())
        return calls

    def call(self) -> Call:
        c = Call(self.take("name"))
        self.take("punct", "(")
        while self.peek() != ("punct", ")"):
            self.arg(c)
            if self.peek() == ("punct", ","):
                self.i += 1
        self.take("punct", ")")
        return c

    def arg(self, c: Call) -> None:
        kind, val = self.peek()
        if kind == "int":  # lo op field op hi
            lo = int(self.take("int"))
            op1 = self.take("op")
            name = self.take("name")
            op2 = self.take("op")
            hi = int(self.take("int"))
            c.conds += [(name, _FLIP[op1], lo), (name, op2, hi)]
        elif kind == "name" and self.peek(1) == ("punct", "("):
            c.args.append(self.call())
        elif kind == "name" and self.peek(1)[0] == "op":
            name = self.take("name")
            op = self.take("op")
            c.conds.append((name, op, int(self.take("int"))))
        elif kind == "name" and self.peek(1) == ("punct", "="):
            name = self.take("name")
            self.take("punct", "=")
            c.kwargs[name] = self.value()
        elif kind == "name":
            c.names.append(self.take("name"))
        else:
            raise ValueError(f"bad argument at {val!r}")

    def value(self) -> Union[int, str, bool, Call]:
        kind, val = self.peek()
        if kind == "name" and self.peek(1) == ("punct", "("):
            return self.call()
        self.i += 1
        if kind == "int":
            return int(val)
        if kind == "str":
            return val[1:-1]
        if kind == "name":
            return {"true": True, "false": False}.get(val, val)
        raise ValueError(f"bad value {val!r}")


def parse(text: str) -> List[Call]:
    """The calls of one query."""
    return _Parser(text).query()
