"""The plain reference of the taxi configurations, in PyTorch.

It answers from the ride columns the configuration made from the seed,
with no bitmaps: a Row leaf is ``column == row``, Intersect and Union
are ``&`` and ``|`` of those masks, Count is the mask's sum, Sum the sum
of the field's values under the mask and the mask's count, and GroupBy
one ``bincount`` of the children's combined key under the filter's mask,
the non-empty groups in ascending order of the row-id tuple (the first
child most significant). Answers are shaped as the server shapes them.
It runs on the card after the program's state is freed, one column
moved there on its first use.

``control=True`` is the control: two plausible wrong optimisations,
Sum over only the low 8 bit planes (each value mod 256), and GroupBy
with ``dist_miles`` capped at row 50, as a bank cut to half its rows
would count it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.pql import Call, parse

CONTROL_SUM_PLANES = 8
CONTROL_MILES_CAP = 50


class Reference:
    def __init__(self, cfg: dict, data: Dict[str, np.ndarray],
                 device: str = "cpu", control: bool = False):
        import torch
        self.torch = torch
        self.fields = cfg["fields"]
        self.data = data
        self.device = device
        self.control = control
        self.cols: Dict[str, Any] = {}
        self.n = int(cfg["rides"])

    def col(self, f: str):
        if f not in self.cols:
            if f not in self.fields:
                raise ValueError(f"no field {f!r}")
            c = self.torch.from_numpy(self.data[f].astype(np.int32)) \
                .to(self.device)
            if self.control and f == "dist_miles":
                c = c.clamp(max=CONTROL_MILES_CAP)
            self.cols[f] = c
        return self.cols[f]

    def mask(self, c: Call):
        torch = self.torch
        if c.name == "Row":
            (f, r), = c.kwargs.items()
            return self.col(f) == int(r)
        if c.name in ("Intersect", "Union") and c.args:
            m = self.mask(c.args[0])
            for a in c.args[1:]:
                m = m & self.mask(a) if c.name == "Intersect" \
                    else m | self.mask(a)
            return m
        if c.name in ("Intersect", "Union"):
            return torch.zeros(self.n, dtype=torch.bool, device=self.device)
        raise ValueError(f"no reference for row call {c.name}")

    def group_by(self, c: Call) -> List[dict]:
        torch = self.torch
        filt = c.kwargs.get("filter")
        m = self.mask(filt) if isinstance(filt, Call) else None
        names, los, sizes = [], [], []
        for a in c.args:
            if a.name != "Rows" or len(a.names) != 1:
                raise ValueError(f"no reference for GroupBy child {a.name}")
            lo, hi = self.fields[a.names[0]]["rows"]
            names.append(a.names[0])
            los.append(lo)
            sizes.append(hi - lo + 1)
        key = torch.zeros((), dtype=torch.int64, device=self.device)
        for f, lo, size in zip(names, los, sizes):
            v = self.col(f) if m is None else self.col(f)[m]
            key = key * size + (v.long() - lo)
        counts = torch.bincount(key.reshape(-1),
                                minlength=int(np.prod(sizes)))
        nz = torch.nonzero(counts).reshape(-1)
        out = []
        for k, n in zip(nz.tolist(), counts[nz].tolist()):
            rows = []
            for lo, size in zip(reversed(los), reversed(sizes)):
                rows.append(lo + k % size)
                k //= size
            out.append({"group": [{"field": f, "rowID": r} for f, r in
                                  zip(names, reversed(rows))],
                        "count": n})
        return out

    def sum(self, c: Call) -> dict:
        f = c.kwargs["field"]
        v = self.col(f)
        if c.args:
            v = v[self.mask(c.args[0])]
        if self.control:
            v = v % (1 << CONTROL_SUM_PLANES)
        return {"value": int(v.sum(dtype=self.torch.int64)),
                "count": int(v.numel())}

    def call(self, c: Call) -> Any:
        if c.name == "GroupBy":
            return self.group_by(c)
        if c.name == "Sum":
            return self.sum(c)
        if c.name == "Count" and len(c.args) == 1:
            return int(self.mask(c.args[0]).sum())
        raise ValueError(f"no reference for {c.name}")

    def answer(self, pql: str) -> List[Any]:
        return [self.call(c) for c in parse(pql)]
