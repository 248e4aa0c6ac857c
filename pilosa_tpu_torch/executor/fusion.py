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

Measurement: ``add`` takes the request's profile and opens its eval
node with the planning time; a group run per member times each member's
evaluation as its dispatch (the dispatch-gap analyzer sees it too), and
a sampled member reads its device time between two CUDA events, counted
in the roofline plane's unattributed fences (no plan, so no bytes). Each
member's seconds feed its signature's entry in the workload recorder.
Evals the result cache answered never reach the collector, so a batch
whose evals all hit forms no group and launches nothing.

Write fencing is the caller's job: ``execute_batch`` flushes the
collector before dispatching any write-containing request and dispatches
that request uncollected, so no read is answered across a write that
orders between them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from pilosa_tpu_torch.utils.roofline import ROOFLINE
from pilosa_tpu_torch.utils.timeline import (
    LANE_DEVICE, LANE_DISPATCH, LANE_PLAN, TIMELINE,
)


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
    """All staged evals sharing one (sig, bank identity) key, with the
    profile and eval node of each member (None when not profiled)."""

    __slots__ = ("executor", "entries", "profs", "nodes", "out", "error")

    def __init__(self, executor: Any) -> None:
        self.executor = executor
        self.entries: List[Any] = []      # _StagedEval, batch order
        self.profs: List[Any] = []        # QueryProfile or None
        self.nodes: List[Any] = []        # ProfileNode or None
        # Per-member results: a list of eager outputs, or a _MegaView
        # onto a megakernel launch; either indexes by member.
        self.out: Any = None
        self.error: Optional[Exception] = None

    def add(self, staged: Any, prof: Any = None,
            t_plan0: float = 0.0) -> FusedEval:
        node = None
        if prof is not None:
            # jit hit/miss and the upload are known only when the group
            # runs; _attribute (or the megakernel's) fills them in.
            plan_s = time.perf_counter() - t_plan0
            node = prof.tree(staged.mode, staged.sig, None, plan_s, 0,
                             staged.n_shards)
            if prof.timeline is not None:
                TIMELINE.event(prof.timeline, "plan", LANE_PLAN, t_plan0,
                               plan_s, fused=True)
        self.entries.append(staged)
        self.profs.append(prof)
        self.nodes.append(node)
        return FusedEval(self, len(self.entries) - 1)

    def run(self) -> None:
        """Run every member through the eager path. Never raises: a
        failure lands on `error` and surfaces per member when its request
        resolves; batchmates in other groups are unharmed."""
        if self.out is not None or self.error is not None:
            return
        try:
            self.out = [self._run_member(b) for b in
                        range(len(self.entries))]
        except Exception as e:
            self.error = e
        finally:
            self.entries, self.profs, self.nodes = [], [], []

    def _run_member(self, b: int) -> Any:
        """One member's eager evaluation, attributed to its profile: its
        own run is its dispatch, and a sampled member its own fence."""
        from pilosa_tpu_torch.executor import executor as ex_mod
        prof, node = self.profs[b], self.nodes[b]
        sampled = prof is not None and node is not None \
            and prof.sample_device
        hit = self.executor._kernels_loaded()
        start = ex_mod._device_mark(self.executor.device) \
            if sampled else None
        t0 = time.perf_counter()
        entry = self.entries[b]
        out = entry.run_eager()
        dispatch_s = time.perf_counter() - t0
        TIMELINE.note_dispatch(t0, dispatch_s)
        if prof is None or node is None:
            if entry.fp is not None:
                WORKLOAD.note_eval_seconds(entry.fp, dispatch_s)
            return out
        self.executor._note_jit(hit)
        prof.tree_jit(node, hit)
        prof.tree_dispatch(node, dispatch_s)
        if prof.timeline is not None:
            TIMELINE.event(prof.timeline, "dispatch", LANE_DISPATCH, t0,
                           dispatch_s)
        device_s = 0.0
        if start is not None:
            t_dev = time.perf_counter()
            device_s = ex_mod._fence_device(start)
            prof.tree_device(node, device_s)
            if prof.timeline is not None:
                TIMELINE.event(prof.timeline, "device", LANE_DEVICE,
                               t_dev, device_s)
            # No plan on this path, so no bytes: the roofline plane
            # states how much sampled device time its bytes explain.
            ROOFLINE.note_unattributed_fence(device_s)
        if entry.fp is not None:
            # What one evaluation of this signature cost: the seconds a
            # result-cache hit saves (the opportunity estimate).
            WORKLOAD.note_eval_seconds(entry.fp, dispatch_s + device_s)
        return out


class FusionCollector:
    """Per-batch registry of staged terminal evals, grouped by fusion
    key. Installed thread-locally by execute_batch (Executor._fusing);
    `flush()` runs every open group."""

    def __init__(self, executor: Any) -> None:
        self.executor = executor
        self.groups: Dict[tuple, _FuseGroup] = {}

    def add(self, staged: Any, prof: Any = None,
            t_plan0: float = 0.0) -> FusedEval:
        """Stage one eval; returns its handle. The signature equates tree
        shape, widths and shard count, and bank identity equates the
        actual device operands (a write rebuilds a bank, so it splits
        groups even without an explicit fence). ``prof``/``t_plan0``:
        the request's profile and when its planning started."""
        key = (staged.sig, tuple(id(a) for a in staged.bank_arrays))
        group = self.groups.get(key)
        if group is None:
            group = self.groups[key] = _FuseGroup(self.executor)
        return group.add(staged, prof, t_plan0)

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
