"""Workload recorder: decayed read and write rates per fragment and row.

This package's own copy of the part of the JAX package's
``utils/hotspots.py`` that the hybrid layout reads. The executor records
each staged read per (index, field, view, shard) fragment and the rows it
names; fragments record their writes; views record the device-bank
rebuilds that writes forced. ``view_read_rates`` sums the decayed
fragment read rates per view: the access axis of the demotion score that
``BankBudget`` eviction and the ``LayoutManager`` pass rank banks by.

Counters are decayed (a rate halves every ``half_life_s`` of quiet; it is
a decayed count, so one read reads as 1.0 at once), cumulative, and
bounded: fragments and rows live in LRU maps. The clock is injectable,
so the decay is testable.

Not ported yet (they wait for the serving planes): the query signature
table, the repeat windows over queries and requests, ``configure``,
``snapshot`` with its bank quadrants and the evicted-entry totals it
proves, and ``/debug/hotspots``.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# Row identities recorded per record_read call; more rows count into
# rowsScanned instead.
ROW_CAP_PER_CALL = 64


class _Decayed:
    """Cumulative count and an exponentially decayed rate."""

    __slots__ = ("count", "rate", "t")

    def __init__(self) -> None:
        self.count = 0
        self.rate = 0.0
        self.t = 0.0

    def add(self, n: int, now: float, half_life_s: float) -> None:
        if self.rate:
            self.rate *= math.pow(0.5, (now - self.t) / half_life_s)
        self.rate += n
        self.t = now
        self.count += n

    def value(self, now: float, half_life_s: float) -> float:
        if not self.rate:
            return 0.0
        return self.rate * math.pow(0.5, max(0.0, now - self.t)
                                    / half_life_s)


class _FragStat:
    __slots__ = ("reads", "writes", "rows_scanned", "generation",
                 "invalidations")

    def __init__(self) -> None:
        self.reads = _Decayed()
        self.writes = _Decayed()
        self.rows_scanned = 0
        self.generation: Optional[int] = None
        self.invalidations = 0  # device-bank rebuilds forced by writes


class WorkloadRecorder:
    """Process-wide registry of reads and writes (see module docstring).
    Thread-safe; ``enabled = False`` makes every record call a no-op."""

    def __init__(self, half_life_s: float = 600.0,
                 max_fragments: int = 4096, max_rows: int = 4096,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.enabled = True
        self.clock = clock
        self.half_life_s = max(0.001, float(half_life_s))
        self._max_fragments = max(1, int(max_fragments))
        self._max_rows = max(1, int(max_rows))
        self._lock = threading.Lock()
        # Insertion-ordered dicts as LRU maps (pop and reinsert on touch).
        self._fragments: Dict[Tuple[str, str, str, int], _FragStat] = {}
        self._rows: Dict[Tuple[str, str, int], _Decayed] = {}
        self._totals = {"fragmentReads": 0, "fragmentWrites": 0,
                        "rowTouches": 0, "rowsScanned": 0,
                        "bankInvalidations": 0}

    # ---------------------------------------------------------- LRU helpers

    def _frag(self, key: Tuple[str, str, str, int]) -> _FragStat:
        st = self._fragments.pop(key, None)
        if st is None:
            st = _FragStat()
        self._fragments[key] = st
        while len(self._fragments) > self._max_fragments:
            self._fragments.pop(next(iter(self._fragments)))
        return st

    def _row(self, key: Tuple[str, str, int]) -> _Decayed:
        st = self._rows.pop(key, None)
        if st is None:
            st = _Decayed()
        self._rows[key] = st
        while len(self._rows) > self._max_rows:
            self._rows.pop(next(iter(self._rows)))
        return st

    # ------------------------------------------------------------ recording

    def record_read(self, index: str, field: str, view: str,
                    shards: Sequence[int],
                    rows: Optional[Sequence[int]] = None,
                    rows_scanned: int = 0) -> None:
        """One staged read over (index, field, view) x shards; ``rows``
        are the row identities it named (at most ROW_CAP_PER_CALL are
        kept, the rest count as scanned)."""
        if not self.enabled:
            return
        now = self.clock()
        hl = self.half_life_s
        row_ids: List[int] = []
        if rows is not None:
            row_ids = list(itertools.islice(rows, ROW_CAP_PER_CALL))
            if len(rows) > ROW_CAP_PER_CALL:
                rows_scanned += len(rows) - ROW_CAP_PER_CALL
        with self._lock:
            for s in shards:
                self._frag((index, field, view, int(s))).reads.add(1, now,
                                                                    hl)
            self._totals["fragmentReads"] += len(shards)
            for r in row_ids:
                self._row((index, field, int(r))).add(1, now, hl)
            self._totals["rowTouches"] += len(row_ids)
            if rows_scanned:
                self._totals["rowsScanned"] += int(rows_scanned)
                if shards:
                    st = self._frag((index, field, view, int(shards[0])))
                    st.rows_scanned += int(rows_scanned)

    def record_write(self, index: str, field: str, view: str,
                     shard: int, generation: Optional[int] = None,
                     n: int = 1) -> None:
        """``n`` row mutations of one fragment in one batch, at the
        fragment's new write version ``generation``."""
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            st = self._frag((index, field, view, int(shard)))
            st.writes.add(n, now, self.half_life_s)
            if generation is not None:
                st.generation = int(generation)
            self._totals["fragmentWrites"] += n

    def record_invalidation(self, index: str, field: str, view: str,
                            shards: Sequence[int]) -> None:
        """A cached device bank over these fragments was stale and had to
        be patched or rebuilt."""
        if not self.enabled:
            return
        with self._lock:
            for s in shards:
                self._frag((index, field, view, int(s))).invalidations += 1
            self._totals["bankInvalidations"] += len(shards)

    # -------------------------------------------------------------- reading

    def view_read_rates(self) -> Dict[Tuple[str, str, str], float]:
        """Summed decayed fragment read rate per (index, field, view)."""
        now = self.clock()
        hl = self.half_life_s
        out: Dict[Tuple[str, str, str], float] = {}
        with self._lock:
            for fk, st in self._fragments.items():
                key = (fk[0], fk[1], fk[2])
                out[key] = out.get(key, 0.0) + st.reads.value(now, hl)
        return out

    def summary(self) -> Dict[str, Any]:
        """Cumulative counters and the tracked map sizes."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "fragmentReads": self._totals["fragmentReads"],
                "fragmentWrites": self._totals["fragmentWrites"],
                "rowTouches": self._totals["rowTouches"],
                "rowsScanned": self._totals["rowsScanned"],
                "bankInvalidations": self._totals["bankInvalidations"],
                "trackedFragments": len(self._fragments),
                "trackedRows": len(self._rows),
            }

    def reset(self) -> None:
        """Drop every tracked entry and total."""
        with self._lock:
            self._fragments.clear()
            self._rows.clear()
            for key in self._totals:
                self._totals[key] = 0


# The process-wide recorder every read and write path reports into.
WORKLOAD = WorkloadRecorder()
