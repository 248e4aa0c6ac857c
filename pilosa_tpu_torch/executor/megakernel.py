"""Executor leg of the heterogeneous megakernel (``ops/megakernel.py``).

``FusionCollector.flush`` hands its signature groups here first. Groups
whose staged evals lowered to megakernel IR are packed, across different
signatures, into one plan buffer and ONE ``mega_interpret`` launch per
shard-count cohort; everything else (Shift trees, cohorts of one group)
flows back to the per-group eager path untouched.

Each taken group's ``out`` becomes a ``_MegaView`` selecting its member
lanes from the launch's shared (counts, rows) outputs. A plan whose
entries read sparse views carries ``xbanks``: ``run_program`` expands
each sparse bank's referenced rows with one ``expand_positions`` launch
into a transient ``[n_x, S, w_mega]`` tensor, which enters the
``mega_interpret`` launch as one more bank at the expand registers'
numbers and plan widths. A plan that reads no bank at all (a cohort of
empty time covers, each the zero row) answers zeros without a launch
and counts in ``mega_launches`` as the JAX package's launch does.

Routing, as in the JAX package's ``executor/megakernel.py``:

- only cohorts of two or more groups per shard count take the launch;
- a cohort whose T x S x W register working set would exceed
  ``MEGA_MAX_BYTES`` (``PILOSA_TPU_MEGA_BYTES``, default 1 GiB) runs per
  group, as in the JAX package, though the card never allocates that
  slab any more: the kernel holds one column tile of the registers at a
  time in shared memory, and the slab survives only in the plain
  version the CPU runs;
- so does a cohort whose T exceeds ``kernels.MEGA_MAX_REGS``, the most
  registers one block's shared memory holds at the narrowest column
  tile (the wrapper refuses such a T); both count in the executor's
  ``mega_budget_fallbacks``;
- an eval whose tree has no IR (a Shift, a time range over more than
  eight views) runs per group; the collector's flush counts it in the
  executor's ``mega_unlowered``;
- a surprise in lowering falls back per group (counted in the
  executor's ``mega_fallbacks``); a surprise in the plan optimizer
  launches the unoptimized plan;
- ``verify_plan`` runs before the first launch of every plan signature
  (``PILOSA_TPU_PLAN_VERIFY``: ``on`` every launch, ``auto`` the first
  of each signature, ``off`` none); a rejected plan, a kernel build
  failure or a launch failure is not a fallback: it lands on the
  cohort's requests as their error.

``MEGAKERNEL_ENABLED`` (``PILOSA_TPU_MEGAKERNEL``: 1 on, 0 off, default
``auto``) is read per executor: ``auto`` means on for a CUDA executor
and off on the CPU. Tests set the module attribute.

Under an executor's mesh (``parallel/mesh.MeshContext``) a cohort is a
mesh cohort launch, as in the JAX package: the plan is verified against
a ``MeshSpec`` carrying ``mesh_epilogue``'s typed collectives, its
signature gains ``|<mesh key>|epi``, and one ``run_program`` runs it,
which launches ``mega_interpret`` once per part over the parts' banks
(the plan copied to each part's device) and finishes with the epilogue:
count lanes summed and row lanes gathered along S on the mesh's first
device. ``plan_cost`` adds the mesh keys, the executor counts the launch
in ``mesh_launches`` and its ``collectiveBytes`` in
``mesh_collective_bytes``, and profiled members get ``meshDevices`` and
``collectiveBytes``. ``MESH_ENABLED`` (``PILOSA_TPU_MESH``, default on)
set to 0 sends mesh requests past the collector (``Executor._fuser``):
no mesh launch, the same bytes.

Measurement, as in the JAX package: after the launch ``plan_cost``
prices the plan from its host buffers (best effort: a surprise there
never fails a request), the roofline plane records it under the cohort
key ``S|W|T|P`` with the optimizer's predicted bytes, and every
profiled member's eval node gets the launch's coordinates and cost
(``megaBatch``, ``megaIndex``, ``planEntries``, ``planBytes``,
``launchBytes``, ``opcodeHist``, ``planEntriesBefore/After``) and its
timeline slices. When a member's profile is sampled, the launch's first
kernel (the expansion, or the interpreter) records a CUDA event on its
stream just before its C entry (``kernels.arm_device_mark``), one more
is recorded after the launch, and the wait on the second gives the
launch's device time, which the roofline plane joins with the bytes.
The reading leaves out the host work before the first kernel and keeps
what runs between the two events: the host gaps between the launch's
kernels (the interpreter's plan upload after an expansion) and the
enqueue gap of the last. An unsampled launch records no event and
takes no sync. A failed fence,
like a failed kernel, is the cohort's requests' error.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops import megakernel as mk
from pilosa_tpu_torch.ops import plan_opt
from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from pilosa_tpu_torch.utils.roofline import ROOFLINE
from pilosa_tpu_torch.utils.timeline import (
    LANE_DEVICE, LANE_DISPATCH, TIMELINE,
)
from pilosa_tpu_torch.utils.tracing import span


def _flag(env: str, default: str) -> str:
    flag = os.environ.get(env, default).strip().lower()
    if flag in ("1", "true", "yes", "on"):
        return "on"
    if flag in ("0", "false", "no", "off"):
        return "off"
    return "auto"


# None = auto (on exactly for a CUDA executor); True/False force it.
MEGAKERNEL_ENABLED: Optional[bool] = {
    "on": True, "off": False}.get(_flag("PILOSA_TPU_MEGAKERNEL", "auto"))

# Register budget per launch: a cohort whose [T, S, W] working set would
# exceed it runs per group instead (the same cohorts as the JAX package).
MEGA_MAX_BYTES = int(os.environ.get("PILOSA_TPU_MEGA_BYTES", 1 << 30))

# Plan verification gate: "on", "off" or "auto".
PLAN_VERIFY_MODE = _flag("PILOSA_TPU_PLAN_VERIFY", "auto")

# The mesh cohort path (PILOSA_TPU_MESH): on unless 0/false/no/off.
MESH_ENABLED = _flag("PILOSA_TPU_MESH", "on") != "off"


def enabled_for(executor: Any) -> bool:
    if MEGAKERNEL_ENABLED is None:
        return executor.device.type == "cuda"
    return bool(MEGAKERNEL_ENABLED)


class _MegaLaunch:
    """One launch's shared outputs: int64 counts [Nc] and row lanes
    [Nr, S, W] on the device; the counts are fetched to the host once."""

    __slots__ = ("counts", "rows", "_host_counts")

    def __init__(self, counts: Any, rows: Any) -> None:
        self.counts = counts
        self.rows = rows
        self._host_counts: Optional[List[int]] = None

    def host_counts(self) -> List[int]:
        if self._host_counts is None:
            with span("Executor.fetch", bytes=8 * int(self.counts.shape[0])):
                self._host_counts = self.counts.tolist()
        return self._host_counts


class _MegaView:
    """One group's window onto a launch: ``[b]`` is member b's count
    (int) or row words (int32 [S, width])."""

    __slots__ = ("launch", "mode", "lanes", "width")

    def __init__(self, launch: _MegaLaunch, mode: str, lanes: List[int],
                 width: int) -> None:
        self.launch = launch
        self.mode = mode
        self.lanes = lanes
        self.width = width

    def __getitem__(self, b: int) -> Any:
        lane = self.lanes[b]
        if self.mode == "count":
            return int(self.launch.host_counts()[lane])
        return self.launch.rows[lane, :, :self.width]


def _eligible(group: Any) -> bool:
    rep = group.entries[0]
    return rep.ir is not None and rep.mode in ("count", "row")


def run_megakernel(executor: Any, groups: Dict[tuple, Any]
                   ) -> Dict[tuple, Any]:
    """Take what lowers, launch one program per shard-count cohort, and
    return the groups the caller must still run per group."""
    if not enabled_for(executor) or (executor.mesh is not None
                                     and not MESH_ENABLED):
        return groups
    cohorts: Dict[int, List[Any]] = {}
    remaining: Dict[tuple, Any] = {}
    for key, group in groups.items():
        if group.entries and _eligible(group):
            cohorts.setdefault(group.entries[0].n_shards, []).append(group)
        else:
            remaining[key] = group
    for n_shards, cohort in cohorts.items():
        if len(cohort) < 2:
            for g in cohort:
                remaining[("solo", id(g))] = g
            continue
        try:
            plan, w_mega, lanes = _build(cohort)
        except Exception:
            # Lowering is best-effort by contract: the per-group path
            # answers instead.
            executor._note_mega_fallback(len(cohort))
            for g in cohort:
                remaining[("fallback", id(g))] = g
            continue
        if mk.slab_nbytes(plan.n_regs, n_shards, w_mega) > MEGA_MAX_BYTES \
                or plan.n_regs > kernels.MEGA_MAX_REGS:
            executor._note_mega_budget_fallback(len(cohort))
            for g in cohort:
                remaining[("budget", id(g))] = g
            continue
        _launch(executor, cohort, plan, n_shards, w_mega, lanes)
    return remaining


def _build(cohort: List[Any]) -> Tuple[mk.Plan, int, List[List[int]]]:
    """Lower every entry of every group into one plan; returns the plan,
    the launch word width and per-group member lanes. The optimizer runs
    here, before the verify gate, so the gate sees the plan that
    launches."""
    w_mega = max(e.width for g in cohort for e in g.entries)
    low = mk.Lowering()
    lanes: List[List[int]] = []
    for g in cohort:
        lanes.append([low.add_entry(e.ir, e.bank_arrays, e.idxs, e.params,
                                    e.width, e.mode) for e in g.entries])
    plan = low.finish()
    try:
        plan, _ = plan_opt.optimize_plan(
            plan, cohort[0].entries[0].n_shards, w_mega)
    except Exception:
        # Best-effort: a surprised optimizer launches the raw plan.
        pass
    return plan, w_mega, lanes


def _zero_lanes(executor: Any, plan: mk.Plan, n_shards: int, w_mega: int
                ) -> Tuple[Any, Any]:
    """The outputs of a plan that reads no bank (every group an empty
    time cover): every register starts at zero and no opcode makes a bit
    from zeros, so each count lane is 0 and each row lane the zero row.
    Nothing launches."""
    dev = executor.device
    return (torch.zeros(len(plan.out_count), dtype=torch.int64, device=dev),
            torch.zeros((len(plan.out_row), n_shards, w_mega),
                        dtype=torch.int32, device=dev))


def _launch(executor: Any, cohort: List[Any], plan: mk.Plan,
            n_shards: int, w_mega: int, lanes: List[List[int]]) -> None:
    from pilosa_tpu_torch.executor import executor as ex_mod
    ex = executor
    n_entries = sum(len(g.entries) for g in cohort)
    sampled = any(p is not None and p.sample_device
                  for g in cohort for p in g.profs)
    start = None
    mesh = ex.mesh
    spec = None
    try:
        key = plan.sig(n_shards, w_mega)
        if mesh is not None:
            # Mesh cohort: one plan, every part; the epilogue types one
            # collective per real output lane.
            spec = mk.MeshSpec(mesh.SHARD_AXIS, mesh.REPLICA_AXIS,
                               mesh.n_shard_devices, mesh.replicas,
                               mk.mesh_epilogue(plan, mesh.SHARD_AXIS))
            key = f"{key}|{mesh.cache_key()}|epi"
        if PLAN_VERIFY_MODE == "on" or (
                PLAN_VERIFY_MODE == "auto"
                and not ex._plan_verified(key)):
            try:
                mk.verify_plan(plan, n_shards, w_mega, mesh=spec)
            except mk.PlanVerifyError:
                ex._note_plan_verify(key, False)
                raise
            ex._note_plan_verify(key, True)
        jit_hit = ex._kernels_loaded()
        if sampled:
            kernels.arm_device_mark()
        t0 = time.perf_counter()
        try:
            if plan.banks or plan.xbanks:
                counts, rows = mk.run_program(plan, n_shards, w_mega)
            else:
                counts, rows = _zero_lanes(ex, plan, n_shards, w_mega)
        finally:
            if sampled:
                # The first kernel's event; the host clock where no
                # kernel ran (the CPU, a plan that reads no bank).
                start = kernels.take_device_mark() or (
                    ex_mod._device_mark(ex.device)
                    if ex.device.type == "cuda" else t0)
        dispatch_s = time.perf_counter() - t0
        TIMELINE.note_dispatch(t0, dispatch_s)
    except Exception as e:
        for g in cohort:
            g.error = e
            g.entries, g.profs, g.nodes = [], [], []
        return
    launch = _MegaLaunch(counts, rows)
    # Cost attribution is best effort: a surprised cost model must never
    # fail a request whose results are already in flight.
    try:
        cost = mk.plan_cost(plan, n_shards, w_mega, mesh=spec)
    except Exception:
        cost = None
    ckey = (f"S{n_shards}|W{w_mega}|T{plan.n_regs}"
            f"|P{plan.instrs.shape[0]}")
    if cost is not None and ROOFLINE.enabled:
        if ROOFLINE.needs_resolve():
            try:
                from pilosa_tpu_torch.utils.benchenv import resolve_roofline
                ROOFLINE.set_resolved(*resolve_roofline(ex.device))
            except Exception:
                pass
        opt = plan.opt_stats
        ROOFLINE.note_launch(
            ckey, cost, opt.predicted_bytes if opt is not None else None)
    try:
        for g, g_lanes in zip(cohort, lanes):
            rep = g.entries[0]
            g.out = _MegaView(launch, rep.mode, g_lanes, rep.width)
        ex._note_mega(n_entries, plan.n_instrs, plan.plan_nbytes)
        if spec is not None:
            ex._note_mesh(spec.n_devices, cost.get("collectiveBytes", 0)
                          if cost is not None else 0)
        if cost is not None:
            ex._note_launch_cost(cost)
        if plan.opt_stats is not None:
            ex._note_opt(plan.opt_stats)
        _attribute(ex, cohort, jit_hit, t0, dispatch_s, plan, n_entries,
                   cost, ckey, start)
    except Exception as e:
        # A failed fence surfaces here: the cohort's groups carry it, so
        # the views already assigned never serve.
        for g in cohort:
            g.error = e
    finally:
        for g in cohort:
            g.entries, g.profs, g.nodes = [], [], []


def _attribute(ex: Any, cohort: List[Any], jit_hit: bool, t_disp: float,
               dispatch_s: float, plan: mk.Plan, n_entries: int,
               cost: Optional[Dict[str, Any]], ckey: str,
               start: Any) -> None:
    """Profiler and timeline attribution, the JAX package's convention:
    the launch ran once for the whole cohort, so every member sees the
    shared dispatch (and sampled device) time, labelled with its launch
    coordinates. ``start`` is the sampled launch's first CUDA event (None
    unsampled): the fence joins the cost with the measured device time in
    the roofline plane."""
    from pilosa_tpu_torch.executor import executor as ex_mod
    fence_profs: List[Tuple[Any, Any]] = []
    opt = plan.opt_stats
    plan_bytes = plan.plan_nbytes
    mega_index = 0
    for g in cohort:
        for prof, node in zip(g.profs, g.nodes):
            b = mega_index
            mega_index += 1
            if prof is None or node is None:
                continue
            ex._note_jit(jit_hit)
            prof.tree_jit(node, jit_hit)
            prof.tree_h2d(node, plan_bytes // max(1, n_entries))
            prof.tree_dispatch(node, dispatch_s)
            node.attrs["megaBatch"] = n_entries
            node.attrs["megaIndex"] = b
            node.attrs["planEntries"] = plan.n_instrs
            node.attrs["planBytes"] = plan_bytes
            if cost is not None:
                node.attrs["launchBytes"] = cost["totalBytes"]
                node.attrs["opcodeHist"] = dict(cost["opcodeHist"])
                if "collectiveBytes" in cost:
                    node.attrs["meshDevices"] = cost["meshDevices"]
                    node.attrs["collectiveBytes"] = \
                        cost["collectiveBytes"]
            if opt is not None:
                node.attrs["planEntriesBefore"] = opt.entries_before
                node.attrs["planEntriesAfter"] = opt.entries_after
            prof.set_fused(n_entries)
            if prof.timeline is not None:
                extra = {}
                if opt is not None:
                    extra = dict(planEntriesBefore=opt.entries_before,
                                 planEntriesAfter=opt.entries_after)
                TIMELINE.event(prof.timeline, "dispatch", LANE_DISPATCH,
                               t_disp, dispatch_s, megaBatch=n_entries,
                               megaIndex=b, planEntries=plan.n_instrs,
                               planBytes=plan_bytes, **extra)
            if prof.sample_device:
                fence_profs.append((prof, node))
    device_s = 0.0
    if start is not None:
        t_dev = time.perf_counter()
        device_s = ex_mod._fence_device(start)
        for prof, node in fence_profs:
            prof.tree_device(node, device_s)
            if prof.timeline is not None:
                TIMELINE.event(prof.timeline, "device", LANE_DEVICE, t_dev,
                               device_s, megaBatch=n_entries)
        if cost is not None:
            bw = ROOFLINE.note_device(ckey, cost["totalBytes"], device_s)
            if bw is not None:
                TIMELINE.note_bandwidth(bw["bytesPerS"], bw["frac"])
    # The cache-opportunity estimate: each entry's share of the launch,
    # the cost basis of the eager and per-group paths.
    per_eval = (dispatch_s + device_s) / max(1, n_entries)
    for g in cohort:
        for e in g.entries:
            if e.fp is not None:
                WORKLOAD.note_eval_seconds(e.fp, per_eval)
