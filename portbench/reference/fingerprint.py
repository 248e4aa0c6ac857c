"""The plain reference of the fingerprint configurations, in PyTorch.

It answers ``TopN(field, Row(field=q), n=N, tanimotoThreshold=T)`` from
the raw positions the configuration made from the seed, by one pass over
every molecule: the molecule's distinct bits, those it shares with q,
floor(100 * shared / (|m| + |q| - shared)) >= T, ranked by shared count
then by row id, the first N with a count above 0. It runs on the card
after the program's state is freed, a block of molecules at a time.

``control=True`` is the control: the same search on fingerprints folded
to half their bits (bit b -> b mod bits/2), the lower resolution a later
PR might store to halve the positions it scans.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.pql import parse

BLOCK = 1 << 21  # molecules a pass


class Reference:
    def __init__(self, cfg: dict, data: Dict[str, np.ndarray],
                 device: str = "cpu", control: bool = False):
        import torch
        self.torch = torch
        self.field = cfg["field"]
        self.bits = int(cfg["bits"]) // (2 if control else 1)
        pos = torch.from_numpy(data["positions"].astype(np.int32))
        if control:
            pos = (pos % self.bits).sort(dim=1).values
        self.pos = pos.to(device)
        keep = torch.ones_like(self.pos, dtype=torch.bool)
        keep[:, 1:] = self.pos[:, 1:] != self.pos[:, :-1]
        self.keep = keep
        self.raw = keep.sum(dim=1)
        n = len(self.pos)
        self.id_bits = max(1, (n - 1).bit_length())
        self.device = device

    def topn(self, q: int, n: int, t: int) -> List[dict]:
        torch = self.torch
        filt = torch.zeros(self.bits, dtype=torch.bool, device=self.device)
        filt[self.pos[q].long()] = True
        shared = torch.empty(len(self.pos), dtype=torch.int64,
                             device=self.device)
        for b0 in range(0, len(self.pos), BLOCK):
            p = self.pos[b0:b0 + BLOCK]
            hit = torch.index_select(filt, 0, p.reshape(-1).long()) \
                .view(p.shape)
            shared[b0:b0 + len(p)] = (hit & self.keep[b0:b0 + len(p)]) \
                .sum(dim=1)
        union = self.raw + self.raw[q] - shared
        ok = (union > 0) & ((shared * 100) // union.clamp(min=1) >= t)
        score = torch.where(ok, shared, torch.zeros_like(shared))
        ids = torch.arange(len(score), device=self.device)
        # Larger count first, then the lower row id.
        key = (score << self.id_bits) | ((1 << self.id_bits) - 1 - ids)
        top = torch.topk(key, min(n, len(key))).values.cpu().tolist()
        out = []
        for k in top:
            count = k >> self.id_bits
            if count <= 0:
                break
            out.append({"id": (1 << self.id_bits) - 1
                        - (k & ((1 << self.id_bits) - 1)), "count": count})
        return out

    def call(self, c) -> Any:
        if c.name != "TopN" or c.names != [self.field]:
            raise ValueError(f"no reference for {c.name}{c.names}")
        q = int(c.args[0].kwargs[self.field])
        return self.topn(q, int(c.kwargs["n"]),
                         int(c.kwargs.get("tanimotoThreshold", 0)))

    def answer(self, pql: str) -> List[Any]:
        return [self.call(c) for c in parse(pql)]
