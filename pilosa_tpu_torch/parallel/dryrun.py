"""The mesh dryrun, after the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``): build an index from a seed, shard its banks
over an n-part mesh and run one query step through the production
``Executor``: the write flush, then Count(Union), TopN, Sum,
Count(Row(n < 500)), GroupBy and its ``previous`` paging, a time
field's ranged Count and Rows, a subset-bank Count under
``BANK_MAX_BYTES = 1``, and, for n >= 4 (even), the same Count and TopN
over a (2 replicas, n/2 shards) mesh. Every answer is checked as the
JAX dryrun checks it.

``python -m pilosa_tpu_torch.parallel.dryrun [N] [--device cpu]``: the
mesh is N slices of the device (``cuda:0`` by default)."""

from __future__ import annotations

import sys
from typing import Any, Dict, Union

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device: Union[str, torch.device]
                     = "cuda") -> Dict[str, Any]:
    """Run the dryrun over ``[device] * n_devices``; returns its answers
    (AssertionError when one is wrong)."""
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
    from pilosa_tpu_torch.parallel.mesh import MeshContext

    mesh = MeshContext([device] * n_devices)
    dev = mesh.device
    holder = Holder(device=dev)
    idx = holder.create_index("dryrun")
    f = idx.create_field("f")
    n_field = idx.create_field("n", FieldOptions(type="int", min=0,
                                                 max=1000))
    rng = np.random.default_rng(7)
    n_shards = 2 * n_devices  # more shards than devices
    cols = rng.choice(n_shards * SHARD_WIDTH, size=5000, replace=False)
    cols = cols.astype(np.uint64)
    # Write step: rows 0..3, BSI values, existence.
    f.import_bits(np.arange(5000, dtype=np.uint64) % 4, cols)
    n_field.import_values(cols[:2000],
                          rng.integers(0, 1000, 2000).astype(np.int64))
    idx.add_existence(cols)

    ex = Executor(holder, device=dev, mesh=mesh)
    (cnt,) = ex.execute("dryrun", "Count(Union(Row(f=0), Row(f=1)))")
    (topn,) = ex.execute("dryrun", "TopN(f, n=2)")
    (s,) = ex.execute("dryrun", 'Sum(Row(f=0), field="n")')
    (rng_row,) = ex.execute("dryrun", "Count(Row(n < 500))")
    (groups,) = ex.execute("dryrun", "GroupBy(Rows(f), Rows(f))")
    (paged,) = ex.execute(
        "dryrun", "GroupBy(Rows(f), Rows(f), previous=[0, 0])")
    idx.create_field("t", FieldOptions(type="time", time_quantum="YMD"))
    ex.execute("dryrun", "Set(3, t=1, 2019-01-02T00:00) "
                         "Set(9, t=1, 2019-03-05T00:00)")
    (tcnt,) = ex.execute(
        "dryrun", "Count(Row(t=1, from=2019-01-01T00:00, "
                  "to=2019-02-01T00:00))")
    (trows,) = ex.execute(
        "dryrun", "Rows(t, from=2019-01-01T00:00, to=2019-04-01T00:00)")
    # The row-subset bank path: the per-bank budget forced down, so the
    # Row leaves build subset banks, still sharded over the mesh.
    orig_max = type(ex).BANK_MAX_BYTES
    try:
        type(ex).BANK_MAX_BYTES = 1
        (cnt2,) = ex.execute("dryrun", "Count(Union(Row(f=0), Row(f=1)))")
    finally:
        type(ex).BANK_MAX_BYTES = orig_max

    rows_mask = (np.arange(5000) % 4) < 2
    assert cnt == int(rows_mask.sum()), (cnt, rows_mask.sum())
    assert cnt2 == cnt, (cnt2, cnt)
    assert len(topn.pairs) == 2
    assert s.count == int(((np.arange(2000) % 4) == 0).sum())
    assert rng_row > 0
    assert len(groups) == 4  # the diagonal (i, i) pairs
    assert len(paged) == 3   # resumes after group (0, 0)
    assert tcnt == 1 and trows.rows == [1]
    out: Dict[str, Any] = {
        "mesh": mesh.shape, "shards": n_shards, "count": cnt,
        "topn": [list(p) for p in topn.pairs], "sum": [s.value, s.count],
        "range_count": rng_row, "groups": len(groups),
        "paged": len(paged), "time_count": tcnt, "time_rows": trows.rows,
        "subset_count": cnt2}

    # The replica axis: the same step over a (replica, shards) mesh;
    # banks are copied across replicas, reductions run over the shard
    # axis only.
    if n_devices >= 4 and n_devices % 2 == 0:
        rmesh = MeshContext([device] * n_devices, replicas=2)
        ex_r = Executor(holder, device=dev, mesh=rmesh)
        (rcnt,) = ex_r.execute("dryrun", "Count(Union(Row(f=0), Row(f=1)))")
        (rtopn,) = ex_r.execute("dryrun", "TopN(f, n=2)")
        assert rcnt == cnt, (rcnt, cnt)
        assert rtopn.pairs == topn.pairs
        out["replica_mesh"] = rmesh.shape
        out["replica_count"] = rcnt
    holder.close()
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="pilosa_tpu_torch.parallel.dryrun")
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}): OK {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
