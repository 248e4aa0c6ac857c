"""Batch collection of staged terminal evals, and their resolution.

Under ``Executor.execute_batch`` a read request's ``Count`` and top-level
bitmap calls do not run at once: each plans its tree into a
``_StagedEval`` (``executor.py``) and hands it to the batch's
``FusionCollector``, which returns a ``FusedEval`` handle. Evals group by
``(sig, bank-tensor identity)``: the same tree shape over the same device
banks. ``flush()`` then runs them all: with more than one group, the
groups go to ``run_megakernel`` (``executor/megakernel.py``) first, which
packs heterogeneous groups into one plan-buffer launch per shard-count
cohort; every group it does not take runs each member through the eager
tree path. The flush counts every eval whose tree has no IR (a Shift, a
time range over more than eight views) in the executor's
``mega_unlowered``, a lone one too. Handles resolve after the flush.

Write fencing is the caller's job: ``execute_batch`` flushes the
collector before dispatching any write-containing request and dispatches
that request uncollected, so no read is answered across a write that
orders between them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class FusedEval:
    """One staged eval's slice of its group's output: ``value()`` is the
    count (``int``) or the row words (int32 ``[S, W]``)."""

    __slots__ = ("group", "b")

    def __init__(self, group: "_FuseGroup", b: int) -> None:
        self.group = group
        self.b = b

    def value(self) -> Any:
        """Valid after the collector's flush, which gives every group
        its output or its error."""
        g = self.group
        if g.error is not None:
            raise g.error
        return g.out[self.b]


class _FuseGroup:
    """All staged evals sharing one (sig, bank identity) key."""

    __slots__ = ("entries", "out", "error")

    def __init__(self) -> None:
        self.entries: List[Any] = []      # _StagedEval, batch order
        # Per-member results: a list of eager outputs, or a _MegaView
        # onto a megakernel launch; either indexes by member.
        self.out: Any = None
        self.error: Optional[Exception] = None

    def add(self, staged: Any) -> FusedEval:
        self.entries.append(staged)
        return FusedEval(self, len(self.entries) - 1)

    def run(self) -> None:
        """Run every member through the eager path. Never raises: a
        failure lands on `error` and surfaces per member when its request
        resolves; batchmates in other groups are unharmed."""
        if self.out is not None or self.error is not None:
            return
        try:
            self.out = [e.run_eager() for e in self.entries]
        except Exception as e:
            self.error = e
        finally:
            self.entries = []


class FusionCollector:
    """Per-batch registry of staged terminal evals, grouped by fusion
    key. Installed thread-locally by execute_batch (Executor._fusing);
    `flush()` runs every open group."""

    def __init__(self, executor: Any) -> None:
        self.executor = executor
        self.groups: Dict[tuple, _FuseGroup] = {}

    def add(self, staged: Any) -> FusedEval:
        """Stage one eval; returns its handle. The signature equates tree
        shape, widths and shard count, and bank identity equates the
        actual device operands (a write rebuilds a bank, so it splits
        groups even without an explicit fence)."""
        key = (staged.sig, tuple(id(a) for a in staged.bank_arrays))
        group = self.groups.get(key)
        if group is None:
            group = self.groups[key] = _FuseGroup()
        return group.add(staged)

    def flush(self) -> None:
        groups, self.groups = self.groups, {}
        if not groups:
            return
        unlowered = sum(len(g.entries) for g in groups.values()
                        if g.entries and g.entries[0].ir is None)
        if unlowered:
            self.executor._note_mega_unlowered(unlowered)
        if len(groups) > 1:
            from pilosa_tpu_torch.executor.megakernel import run_megakernel
            groups = run_megakernel(self.executor, groups)
        for group in groups.values():
            group.run()
