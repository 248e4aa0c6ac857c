"""The fingerprint configurations: molecules from the seed, the index
built through the port's bulk import, and the least bytes a query needs.

Molecule m is row m; its fingerprint is ``draws`` draws of ``bits``
bits (draws may repeat), sorted. Molecules come in families of
``family`` around a scaffold of ``draws`` uniform draws: each member
keeps k of its scaffold's distinct bits, k uniform over
[share_min, min(share_max, distinct)], chosen uniformly, and draws the
rest uniformly over all bits. So every query molecule has neighbours.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.pql import Call

PAIR_BYTES = 16  # one TopN answer pair: a row id and a count


def generate(cfg: dict, seed: int, device: str) -> Dict[str, np.ndarray]:
    """``positions``: uint16 [molecules, draws], each row sorted, made on
    ``device`` from ``seed`` a chunk of ``load_chunk`` molecules at a
    time."""
    import torch
    n, bits, draws = int(cfg["molecules"]), int(cfg["bits"]), \
        int(cfg["draws"])
    fam, chunk = int(cfg["family"]), int(cfg["load_chunk"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    n_fam = -(-n // fam)
    scaf = torch.randint(0, bits, (n_fam, draws), generator=g,
                         device=device).sort(dim=1).values
    dup = torch.zeros_like(scaf, dtype=torch.bool)
    dup[:, 1:] = scaf[:, 1:] == scaf[:, :-1]
    distinct = draws - dup.sum(dim=1)
    lane = torch.arange(draws, device=device)
    out = np.empty((n, draws), np.uint16)
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        f = torch.arange(c0, c0 + m, device=device) // fam
        hi = torch.clamp(distinct[f], max=int(cfg["share_max"]))
        lo = torch.clamp(hi, max=int(cfg["share_min"]))
        u = torch.rand(m, generator=g, device=device)
        k = lo + (u * (hi - lo + 1)).long()
        # Distinct scaffold bits first (a repeat sorts last), shuffled.
        key = torch.rand((m, draws), generator=g, device=device) + \
            dup[f].float() * 2
        shared = scaf[f].gather(1, key.argsort(dim=1))
        extra = torch.randint(0, bits, (m, draws), generator=g,
                              device=device)
        row = torch.where(lane[None, :] < k[:, None], shared, extra)
        out[c0:c0 + m] = row.sort(dim=1).values.to(torch.int32).cpu() \
            .numpy()
    return {"positions": out}


def load(cfg: dict, data: Dict[str, np.ndarray], device: str):
    """The index in a new in-memory port Holder through
    ``Field.import_bits``, ``load_chunk`` molecules a call. Returns the
    holder."""
    from pilosa_tpu_torch import FieldOptions, Holder
    pos = data["positions"]
    draws, chunk = pos.shape[1], int(cfg["load_chunk"])
    holder = Holder(device=device)
    idx = holder.create_index(cfg["index"], track_existence=False)
    field = idx.create_field(cfg["field"],
                             FieldOptions(max_columns=int(cfg["bits"])))
    for c0 in range(0, len(pos), chunk):
        part = pos[c0:c0 + chunk]
        field.import_bits(
            np.repeat(np.arange(c0, c0 + len(part), dtype=np.uint64),
                      draws), part.reshape(-1).astype(np.uint64))
    return holder


def distinct_bits(pos: np.ndarray) -> np.ndarray:
    """Distinct bits of each row of sorted positions (int64)."""
    if pos.shape[1] == 0:
        return np.zeros(len(pos), np.int64)
    return 1 + (pos[:, 1:] != pos[:, :-1]).sum(axis=1, dtype=np.int64)


def least_bytes(calls: List[Call], cfg: dict, data) -> int:
    """A scan of every molecule's distinct bits at 2 bytes each, as a
    roaring array container holds them, plus the query row and the
    answer, for each TopN call. An algorithm that reads less (an index by
    bit) would need this count redone."""
    pos = data["positions"]
    if "_distinct" not in data:
        data["_distinct"] = distinct_bits(pos)
    raw = data["_distinct"]
    total = 0
    for c in calls:
        if c.name != "TopN":
            raise ValueError(f"no least-bytes rule for {c.name}")
        total += 2 * int(raw.sum()) + PAIR_BYTES * int(c.kwargs["n"])
        for a in c.args:
            q = a.kwargs.get(cfg["field"])
            if q is not None:
                total += 2 * int(raw[int(q)])
    return total
