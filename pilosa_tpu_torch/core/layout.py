"""Hybrid device layout: the pass that moves views between dense and
sparse device banks.

This package's own copy of the JAX package's ``core/layout.py``. Dense
``ViewBank`` rows pad to the view's trimmed width, so a nearly empty row
costs as much device memory as a full one. A view demoted to the sparse
layout serves its Row leaves from a ``SparseBank`` (its set positions,
about 4 bytes a set bit), expanded on the card by the ``expand_positions``
kernel into exactly the dense rows they replace; hot or dense views stay
dense.

``LayoutManager.relayout_once`` joins the ledger's dense bank entries
(bytes, padding, sampled live density) against the workload recorder's
per-view read rates and demotes by the score ``(1 - density) * bytes /
(1 + rate)``, highest first: every candidate when the device bytes are
over the watermark, otherwise only banks under the density threshold
that are not hot. It promotes sparse views whose read rate climbed above
the promotion threshold. A flip changes the representation, never the
data, and both hold the same bits.

The pass's counters go to the server's stats client as they move
(``pilosa_layout_{demotions,promotions,relayout_runs}_total``) and
``publish`` exports its gauges (``pilosa_layout_sparse_views``,
``_sparse_bank_bytes``, ``_bytes_reclaimed``) at scrape time.

``HYBRID_LAYOUT_ENABLED`` (the JAX package's ``PILOSA_TPU_HYBRID_LAYOUT``,
here a module attribute with its default) turns off sparse planning and
the pass; answers are the same either way.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from pilosa_tpu_torch.core.view import VIEW_BSI_PREFIX
from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from pilosa_tpu_torch.utils.locks import make_lock
from pilosa_tpu_torch.utils.memledger import LEDGER

_LOG = logging.getLogger(__name__)

HYBRID_LAYOUT_ENABLED = True


def entry_density_score(info: Dict[str, Any],
                        rate: float) -> Optional[Tuple[float, float]]:
    """(density, demotion score) of one ledger bank entry: density is
    the unpadded share times the clamped sampled live density, the score
    ``(1 - density) * bytes / (1 + rate)``. None for an entry without
    bytes."""
    nbytes = int(info.get("bytes", 0) or 0)
    if nbytes <= 0:
        return None
    padded = int(info.get("paddedBytes", 0) or 0)
    density = max(0.0, 1.0 - padded / nbytes)
    live = info.get("liveDensity")
    if live is not None:
        try:
            density *= max(0.0, min(1.0, float(live)))
        except (TypeError, ValueError):
            pass
    return density, (1.0 - density) * nbytes / (1.0 + rate)


def demotion_scores(entries: Iterable[Any]) -> Dict[Any, float]:
    """Demotion score per BankBudget entry key ((id(view), cache_key))
    for the entries the ledger can price; the others are absent (the
    budget treats them as 0 and falls back to LRU)."""
    from pilosa_tpu_torch.core.view import BankBudget

    rates = WORKLOAD.view_read_rates()
    out: Dict[Any, float] = {}
    for ek in entries:
        info = LEDGER.entry_info(BankBudget.LEDGER_CATEGORIES, ek)
        if info is None:
            continue
        ds = entry_density_score(
            info, rates.get((info.get("index", ""), info.get("field", ""),
                             info.get("view", "")), 0.0))
        if ds is not None:
            out[ek] = ds[1]
    return out


class LayoutManager:
    """The re-layout pass and its counters. ``relayout_once()`` is one
    pass; ``start()`` runs it every ``interval_s`` on a thread. One pass
    at a time."""

    def __init__(self, holder: Any, interval_s: float = 30.0,
                 demote_density: float = 0.25, min_bytes: int = 1 << 20,
                 promote_rate: float = 0.5, watermark_bytes: int = 0,
                 logger: Optional[logging.Logger] = None,
                 stats: Optional[Any] = None) -> None:
        self.holder = holder
        self.stats = stats
        self.enabled = True
        self.interval_s = max(0.0, float(interval_s))
        self.demote_density = float(demote_density)
        self.min_bytes = int(min_bytes)
        self.promote_rate = float(promote_rate)
        self.watermark_bytes = int(watermark_bytes)
        self.logger = logger or _LOG
        self._lock = make_lock("LayoutManager._lock")
        self._run_lock = make_lock("LayoutManager._run_lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.relayout_runs = 0
        self.demotions = 0
        self.promotions = 0
        self.demote_failures = 0
        self.bytes_reclaimed = 0   # device-byte drop summed over runs
        self.last_run_at: Optional[float] = None
        self.last_delta_bytes = 0  # signed device delta of the last run

    def configure(self, enabled: Optional[bool] = None,
                  interval_s: Optional[float] = None,
                  demote_density: Optional[float] = None,
                  min_bytes: Optional[int] = None,
                  promote_rate: Optional[float] = None,
                  watermark_bytes: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if interval_s is not None:
                self.interval_s = max(0.0, float(interval_s))
            if demote_density is not None:
                self.demote_density = float(demote_density)
            if min_bytes is not None:
                self.min_bytes = int(min_bytes)
            if promote_rate is not None:
                self.promote_rate = float(promote_rate)
            if watermark_bytes is not None:
                self.watermark_bytes = int(watermark_bytes)

    # ------------------------------------------------------------ the pass

    def _resolve_view(self, index: str, field: str,
                      view: str) -> Optional[Any]:
        idx = self.holder.index(index)
        f = idx.field(field) if idx is not None else None
        return f.view(view) if f is not None else None

    @staticmethod
    def _eligible(view: Any) -> bool:
        """A Row-leaf view (BSI plane banks stay dense) whose trimmed
        width fits the u16 bit-position encoding."""
        from pilosa_tpu_torch.core.fragment import CONTAINER_BITS
        if view is None or view.name.startswith(VIEW_BSI_PREFIX):
            return False
        if not view.fragments:
            return False
        return bool(view.trimmed_words() * 32 <= CONTAINER_BITS)

    def _sparse_views(self) -> List[Any]:
        out: List[Any] = []
        for idx in list(self.holder.indexes.values()):
            for f in list(idx.fields.values()):
                for v in list(f.views.values()):
                    if v.layout_mode == "sparse":
                        out.append(v)
        return out

    def demote(self, view: Any) -> bool:
        """Dense to sparse: compact the host storage (a point write
        leaves its row's container dense), drop the dense banks and build
        the SparseBank at once, so the byte delta shows in the ledger
        now. Reverts, counting a failure, when the view is too dense for
        positions."""
        if not self._eligible(view):
            return False
        for frag in list(view.fragments.values()):
            try:
                frag.optimize_storage()
            except Exception:
                pass  # compaction helps the gather; it never gates it
        view.set_layout("sparse")
        shards = tuple(view.available_shards())
        bank = view.sparse_bank(shards) if shards else None
        if shards and bank is None:
            view.set_layout("dense")
            with self._lock:
                self.demote_failures += 1
            return False
        with self._lock:
            self.demotions += 1
        self._count("layout.demotions")
        self.logger.info(
            "layout: demoted %s/%s/%s to sparse (%d rows, %d bytes "
            "resident)", view.index, view.field, view.name,
            bank.n_rows if bank else 0, bank.nbytes if bank else 0)
        return True

    def promote(self, view: Any) -> bool:
        """Sparse to dense: drop the SparseBank; the dense bank builds on
        the next read."""
        if not view.set_layout("dense"):
            return False
        with self._lock:
            self.promotions += 1
        self._count("layout.promotions")
        self.logger.info("layout: promoted %s/%s/%s to dense", view.index,
                         view.field, view.name)
        return True

    def relayout_once(self) -> Dict[str, Any]:
        """One complete pass; returns its summary."""
        if not (self.enabled and HYBRID_LAYOUT_ENABLED):
            return {"ran": False, "reason": "disabled"}
        with self._run_lock:
            device_before = LEDGER.total_bytes(device_only=True)
            over = bool(self.watermark_bytes
                        and device_before >= self.watermark_bytes)
            rates = WORKLOAD.view_read_rates()
            demoted = promoted = 0
            cands: List[Tuple[float, float, Dict[str, Any]]] = []
            for e in LEDGER.entries("bank"):
                if int(e.get("bytes", 0) or 0) < self.min_bytes \
                        or not e.get("view"):
                    continue
                rate = rates.get((e["index"], e["field"], e["view"]), 0.0)
                ds = entry_density_score(e, rate)
                if ds is None:
                    continue
                density, score = ds
                cands.append((score, density, e))
            cands.sort(key=lambda c: -c[0])
            for score, density, e in cands:
                # Over the watermark the ranking demotes top-down; below
                # it only banks under the density threshold move.
                if not over and density > self.demote_density:
                    continue
                view = self._resolve_view(e["index"], e["field"],
                                          e["view"])
                if view is None or view.layout_mode == "sparse":
                    continue
                rate = rates.get((e["index"], e["field"], e["view"]), 0.0)
                if rate > self.promote_rate and not over:
                    continue  # hot stays dense unless pressure forces it
                if self.demote(view):
                    demoted += 1
            for view in self._sparse_views():
                rate = rates.get((view.index, view.field, view.name), 0.0)
                if rate > self.promote_rate:
                    if self.promote(view):
                        promoted += 1
            device_after = LEDGER.total_bytes(device_only=True)
            delta = device_after - device_before
            with self._lock:
                self.relayout_runs += 1
                self.last_run_at = time.time()
                self.last_delta_bytes = delta
                if delta < 0:
                    self.bytes_reclaimed += -delta
            self._count("layout.relayout_runs")
            return {"ran": True, "overWatermark": over,
                    "demoted": demoted, "promoted": promoted,
                    "deviceBytesBefore": device_before,
                    "deviceBytesAfter": device_after,
                    "deltaBytes": delta}

    def snapshot(self) -> Dict[str, Any]:
        """The pass's counters and the sparse views' resident bytes."""
        sparse = self._sparse_views()
        sparse_bytes = int(LEDGER.totals().get("sparse_bank", {})
                           .get("bytes", 0))
        with self._lock:
            return {
                "enabled": bool(self.enabled and HYBRID_LAYOUT_ENABLED),
                "sparseViews": len(sparse),
                "sparseBankBytes": sparse_bytes,
                "relayoutRuns": self.relayout_runs,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "demoteFailures": self.demote_failures,
                "bytesReclaimed": self.bytes_reclaimed,
                "lastRunAt": self.last_run_at,
                "lastDeltaBytes": self.last_delta_bytes,
                "watermarkBytes": self.watermark_bytes,
            }

    def _count(self, name: str) -> None:
        if self.stats is not None:
            self.stats.count(name, 1)

    def publish(self, stats: Optional[Any]) -> None:
        """Scrape-time gauges; the counters count as they move."""
        if stats is None:
            return
        s = self.snapshot()
        stats.gauge("layout.sparse_views", s["sparseViews"])
        stats.gauge("layout.sparse_bank_bytes", s["sparseBankBytes"])
        stats.gauge("layout.bytes_reclaimed", s["bytesReclaimed"])

    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.relayout_once()
                except Exception:
                    pass  # one bad pass must not end the layout thread

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="layout-relayout")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval_s + 5)
            self._thread = None
