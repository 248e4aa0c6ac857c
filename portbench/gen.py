"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and makes its requests from the seed.

A mix file holds what a source of traffic states, and nothing of how
the harness drives it:

- ``index``: the index the requests go to;
- ``rate_per_s``: requests due a second in the window, an open loop
  (``loadgen.py``), fixed in the cell;
- ``pick``: ``"all"`` (every call template once a request, in order) or
  ``"one"`` (one template a request, drawn by ``weight``);
- ``calls``: templates ``{"pql": ..., "params": {...}, "weight": w}``.

A parameter is ``{"int": [lo, hi]}``, drawn uniformly from [lo, hi).
``lo`` and ``hi`` are integers, ``"$key"`` (a size of the configuration),
or ``"name"`` / ``"name+K"`` / ``"name-K"`` (a parameter drawn before it
in the same template). Request ``seq`` of client ``client`` in a stream
depends on (seed, stream, client, seq) alone, so every process that
makes it makes the same text.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple

import numpy as np

STREAMS = {"window": 1, "warm": 2, "probe": 3}
_REF = re.compile(r"^([A-Za-z_]\w*)([+-]\d+)?$")


def load_mix(path: str) -> dict:
    with open(path) as f:
        mix = json.load(f)
    if mix.get("pick") not in ("all", "one"):
        raise ValueError(f"{path}: pick must be 'all' or 'one'")
    for t in mix["calls"]:
        for name, spec in t.get("params", {}).items():
            if set(spec) != {"int"} or len(spec["int"]) != 2:
                raise ValueError(f"{path}: parameter {name}: {spec}")
    return mix


class Traffic:
    """The requests of one mix over one configuration's sizes."""

    def __init__(self, mix: dict, sizes: Dict[str, int], seed: int):
        self.mix = mix
        self.sizes = sizes
        self.seed = int(seed) % (1 << 64)
        w = np.array([t.get("weight", 1) for t in mix["calls"]], float)
        self.cum = np.cumsum(w / w.sum())

    def _bound(self, v, drawn: Dict[str, int]) -> int:
        if isinstance(v, int):
            return v
        if v.startswith("$"):
            return int(self.sizes[v[1:]])
        m = _REF.match(v)
        if m is None or m.group(1) not in drawn:
            raise ValueError(f"bad parameter bound {v!r}")
        return drawn[m.group(1)] + int(m.group(2) or 0)

    def _fill(self, template: dict, rng: np.random.Generator) -> str:
        drawn: Dict[str, int] = {}
        for name, spec in template.get("params", {}).items():
            lo, hi = (self._bound(b, drawn) for b in spec["int"])
            drawn[name] = int(rng.integers(lo, hi))
        return template["pql"].format(**drawn)

    def request(self, stream: str, client: int, seq: int) -> Tuple[str, int]:
        """(PQL text, number of calls) of one request."""
        rng = np.random.default_rng(
            [self.seed, STREAMS[stream], client, seq])
        calls = self.mix["calls"]
        if self.mix["pick"] == "all":
            chosen = calls
        else:
            i = int(np.searchsorted(self.cum, rng.random(), side="right"))
            chosen = [calls[min(i, len(calls) - 1)]]
        return "\n".join(self._fill(t, rng) for t in chosen), len(chosen)

    def probes(self, sent: set, n: int) -> List[str]:
        """``n`` requests of the probe stream none of whose calls is in
        ``sent`` (the calls sent before), so no cache can answer them."""
        out: List[str] = []
        seq = 0
        while len(out) < n:
            text, _ = self.request("probe", 0, seq)
            seq += 1
            if seq > 1000 * n:
                raise RuntimeError("no fresh probe request found")
            if not any(c in sent for c in text.split("\n")):
                out.append(text)
        return out
