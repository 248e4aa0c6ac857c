"""PQL AST: Query -> Call tree with args and conditions.

Mirrors reference pql/ast.go: `Call` (:247) holds a name, an argument
map, and child calls; `Condition` (:466) is a comparison operator + operand
used as an argument value (`Row(x > 5)`); positional tokens are stored under
reserved arg keys `_field`, `_col`, `_row`, `_start`, `_end`, `_timestamp`
(pql.peg `reserved`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Condition operators (reference token names, pql/token.go).
EQ = "=="
NEQ = "!="
LT = "<"
LTE = "<="
GT = ">"
GTE = ">="
BETWEEN = "><"


@dataclass
class Condition:
    op: str
    value: Any  # int/float, or [low, high] for BETWEEN (inclusive bounds)

    def int_slice(self) -> List[int]:
        if not isinstance(self.value, list):
            raise ValueError(f"expected list value, got {self.value!r}")
        return [int(v) for v in self.value]

    def __str__(self) -> str:
        return f"{self.op} {self.value}"


@dataclass
class Call:
    name: str
    args: Dict[str, Any] = field(default_factory=dict)
    children: List["Call"] = field(default_factory=list)

    def arg(self, key: str, default: Any = None) -> Any:
        return self.args.get(key, default)

    def clone(self) -> "Call":
        """Fresh Call tree with its OWN args dicts, children lists,
        Call-valued args (GroupBy filter), list-valued args (previous,
        ids), and Conditions — every structure the executor's key
        translation can write resolved ids into (executor.py
        _translate_call mutates args in place, including nested filter
        trees and `previous` lists). Scalars are shared (immutable)."""
        args: Dict[str, Any] = {}
        for k, v in self.args.items():
            if isinstance(v, Call):
                v = v.clone()
            elif isinstance(v, Condition):
                v = Condition(v.op, list(v.value)
                              if isinstance(v.value, list) else v.value)
            elif isinstance(v, list):
                v = list(v)
            args[k] = v
        return Call(self.name, args, [c.clone() for c in self.children])

    def uint_arg(self, key: str) -> Optional[int]:
        v = self.args.get(key)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"arg {key!r} must be numeric, got {v!r}")
        return int(v)

    def has_condition_arg(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def condition_field(self) -> Optional[str]:
        for k, v in self.args.items():
            if isinstance(v, Condition):
                return k
        return None

    def writes(self) -> bool:
        return self.name in ("Set", "Clear", "ClearRow", "Store",
                             "SetRowAttrs", "SetColumnAttrs")

    def to_pql(self) -> str:
        """Serialize back to parseable PQL (the reference serializes Calls
        with String() for remote re-execution, pql/ast.go:418)."""
        def val(v) -> str:
            if v is None:
                return "null"
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, str):
                escaped = v.replace("\\", "\\\\").replace("'", "\\'")
                return f"'{escaped}'"
            if isinstance(v, list):
                return "[" + ", ".join(val(x) for x in v) + "]"
            if isinstance(v, Call):
                return v.to_pql()
            return repr(v)

        def plain_args(skip=()):
            parts = []
            for k in self.args:
                if k.startswith("_") or k in skip:
                    continue
                v = self.args[k]
                if isinstance(v, Condition):
                    parts.append(f"{k} {v.op} {val(v.value)}")
                else:
                    parts.append(f"{k}={val(v)}")
            return parts

        name = self.name
        if name in ("Set", "Clear"):
            parts = [val(self.args["_col"])] + plain_args()
            if name == "Set" and self.args.get("_timestamp"):
                parts.append(val(self.args["_timestamp"]))
            return f"{name}({', '.join(parts)})"
        if name == "SetColumnAttrs":
            parts = [val(self.args["_col"])] + plain_args()
            return f"{name}({', '.join(parts)})"
        if name == "SetRowAttrs":
            parts = [self.args["_field"], val(self.args["_row"])] \
                + plain_args()
            return f"{name}({', '.join(parts)})"
        if name == "Store":
            parts = [self.children[0].to_pql()] + plain_args()
            return f"{name}({', '.join(parts)})"
        if name in ("TopN", "Rows"):
            parts = [self.args["_field"]] \
                + [c.to_pql() for c in self.children] + plain_args()
            return f"{name}({', '.join(parts)})"
        parts = [c.to_pql() for c in self.children] + plain_args()
        return f"{name}({', '.join(parts)})"

    def __str__(self) -> str:
        parts = [str(c) for c in self.children]
        for k in sorted(self.args):
            v = self.args[k]
            if isinstance(v, Condition):
                parts.append(f"{k} {v}")
            else:
                parts.append(f"{k}={v!r}")
        return f"{self.name}({', '.join(parts)})"


@dataclass
class Query:
    calls: List[Call] = field(default_factory=list)

    def clone(self) -> "Query":
        return Query([c.clone() for c in self.calls])

    def __str__(self) -> str:
        return "\n".join(str(c) for c in self.calls)
