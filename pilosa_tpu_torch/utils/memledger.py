"""Memory ledger and the watchdog that samples it.

This package's own copy of the JAX package's ``utils/memledger.py``.
The port keeps its index resident as device banks, so device memory
decides how many shards a card holds; the ledger answers what occupies
it and how much of that is padding:

- ``MemoryLedger``: a process-wide registry every long-lived device
  allocation (and host cache) registers with: view banks, positions
  banks, sparse banks, rank vectors, host blocks. Each entry carries its
  bytes and its padded bytes, so pow2 padding is a number. Keys are
  scoped to an ``owner`` object where one exists; a collected owner's
  entries go with it (``weakref.finalize``).
- ``MemoryWatchdog``: a sampling thread that snapshots the ledger's
  totals into a bounded ring and logs a warning, with the largest
  device entries, when the device bytes cross a watermark.

Host-only: no device work, so sampling never waits on the card.
``MemoryLedger.publish`` exports the ``pilosa_memory_*`` gauges that
``/metrics`` serves; ``/debug/memory`` serves the snapshot. The ring's
dump on SIGTERM is not ported yet.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

_LOG = logging.getLogger(__name__)

# Categories whose bytes live in host memory, not on the card: left out
# of the device total and the watchdog's watermark.
HOST_CATEGORIES = frozenset({"host_block", "telemetry", "result_cache"})


class _Entry:
    __slots__ = ("category", "key", "nbytes", "padded", "meta", "oid")

    def __init__(self, category: str, key: Any, nbytes: int,
                 padded: int, meta: Dict[str, Any],
                 oid: Optional[int] = None) -> None:
        self.category = category
        self.key = key
        self.nbytes = int(nbytes)
        self.padded = int(padded)
        self.meta = meta
        # id() of the owner the entry was registered under: an eviction
        # unregisters by the scoped key alone and must still clean the
        # owner's key set.
        self.oid = oid


class MemoryLedger:
    """Thread-safe registry of live allocations, grouped by category.

    ``register`` replaces an existing (category, key) entry in place, so
    totals never count a rebuilt bank twice; ``unregister`` is
    idempotent. Finalizers run at arbitrary allocation points, possibly
    while this thread holds a lock, so they only append to ``_dead``;
    every public operation drains that queue first."""

    TOP_K = 10

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._entries: Dict[Tuple[str, Any], _Entry] = {}
        # category -> [bytes, padded, count]; a category stays at zero
        # once seen.
        self._totals: Dict[str, List[int]] = {}
        # id(owner) -> set of (category, key) to purge at collection.
        self._owned: Dict[int, set] = {}
        # ("entry", (category, key)) | ("owner", oid), pending.
        self._dead: deque = deque()

    # ------------------------------------------------------------ mutation

    def _scoped(self, key: Any, owner: Optional[Any]) -> Any:
        return (id(owner), key) if owner is not None else key

    def _note_dead(self, kind: str, payload: Any) -> None:
        """weakref.finalize target: lock-free by contract."""
        self._dead.append((kind, payload))

    def _drain_dead(self) -> None:
        while True:
            try:
                kind, payload = self._dead.popleft()
            except IndexError:
                return
            if kind == "owner":
                self._purge_owner(payload)
            else:
                category, key = payload
                self._unregister_now(category, key, None)

    def register(self, category: str, key: Any, nbytes: int,
                 padded_bytes: int = 0, owner: Optional[Any] = None,
                 **meta: Any) -> None:
        """Track (or replace) one allocation; ``owner`` scopes the key to
        a live object and purges it at the object's collection."""
        self._drain_dead()
        k = self._scoped(key, owner)
        entry = _Entry(category, k, max(0, int(nbytes)),
                       max(0, int(padded_bytes)), meta,
                       oid=id(owner) if owner is not None else None)
        with self._lock:
            if owner is not None:
                oid = id(owner)
                owned = self._owned.get(oid)
                if owned is None:
                    owned = self._owned[oid] = set()
                    weakref.finalize(owner, self._note_dead, "owner", oid)
                owned.add((category, k))
            old = self._entries.get((category, k))
            tot = self._totals.setdefault(category, [0, 0, 0])
            if old is not None:
                tot[0] -= old.nbytes
                tot[1] -= old.padded
                tot[2] -= 1
            self._entries[(category, k)] = entry
            tot[0] += entry.nbytes
            tot[1] += entry.padded
            tot[2] += 1

    def unregister(self, category: str, key: Any,
                   owner: Optional[Any] = None) -> None:
        self._drain_dead()
        self._unregister_now(category, key, owner)

    def _unregister_now(self, category: str, key: Any,
                        owner: Optional[Any]) -> None:
        k = self._scoped(key, owner)
        with self._lock:
            old = self._entries.pop((category, k), None)
            if old is None:
                return
            tot = self._totals.get(category)
            if tot is not None:
                tot[0] -= old.nbytes
                tot[1] -= old.padded
                tot[2] -= 1
            if old.oid is not None:
                owned = self._owned.get(old.oid)
                if owned is not None:
                    owned.discard((category, k))

    def _purge_owner(self, oid: int) -> None:
        with self._lock:
            for category, k in self._owned.pop(oid, ()):
                old = self._entries.pop((category, k), None)
                if old is None:
                    continue
                tot = self._totals.get(category)
                if tot is not None:
                    tot[0] -= old.nbytes
                    tot[1] -= old.padded
                    tot[2] -= 1

    def track(self, obj: Any, category: str, nbytes: int,
              padded_bytes: int = 0, **meta: Any) -> None:
        """Register an allocation that lives exactly as long as ``obj``,
        keyed on it and dropped at its collection."""
        key = ("obj", id(obj))
        self.register(category, key, nbytes, padded_bytes, **meta)
        weakref.finalize(obj, self._note_dead, "entry", (category, key))

    # ------------------------------------------------------------- reading

    def totals(self) -> Dict[str, Dict[str, int]]:
        self._drain_dead()
        with self._lock:
            return {c: {"bytes": t[0], "paddedBytes": t[1], "count": t[2]}
                    for c, t in sorted(self._totals.items())}

    def total_bytes(self, device_only: bool = False) -> int:
        self._drain_dead()
        with self._lock:
            return sum(t[0] for c, t in self._totals.items()
                       if not (device_only and c in HOST_CATEGORIES))

    def top(self, k: int = TOP_K,
            device_only: bool = False) -> List[Dict[str, Any]]:
        """The k largest live entries; ``device_only`` leaves out the
        host categories."""
        self._drain_dead()
        with self._lock:
            entries = sorted(
                (e for e in self._entries.values() if e.nbytes > 0
                 and not (device_only and e.category in HOST_CATEGORIES)),
                key=lambda e: e.nbytes, reverse=True)[:k]
            return [{"category": e.category, "bytes": e.nbytes,
                     "paddedBytes": e.padded, **e.meta} for e in entries]

    def entry_info(self, categories, key: Any) -> Optional[Dict[str, Any]]:
        """Bytes, padding and meta of the live entry for the already
        scoped ``key`` under any of ``categories``, or None."""
        self._drain_dead()
        with self._lock:
            for c in categories:
                e = self._entries.get((c, key))
                if e is not None:
                    return {"category": c, "bytes": e.nbytes,
                            "paddedBytes": e.padded, **e.meta}
        return None

    def entries(self, *categories: str) -> List[Dict[str, Any]]:
        """Every live entry of the given categories with its bytes,
        padding and meta."""
        self._drain_dead()
        with self._lock:
            return [{"category": e.category, "bytes": e.nbytes,
                     "paddedBytes": e.padded, **e.meta}
                    for e in self._entries.values()
                    if e.category in categories]

    def snapshot(self, top_k: int = TOP_K) -> Dict[str, Any]:
        """Totals by category, their sums and the largest entries, all
        from one totals read."""
        cats = self.totals()
        return {
            "totalBytes": sum(c["bytes"] for c in cats.values()),
            "deviceBytes": sum(c["bytes"] for name, c in cats.items()
                               if name not in HOST_CATEGORIES),
            "paddingBytes": sum(c["paddedBytes"] for c in cats.values()),
            "categories": cats,
            "top": self.top(top_k),
        }

    def publish(self, stats: Optional[Any]) -> None:
        """Export per-category gauges: pilosa_memory_bytes{category},
        pilosa_memory_padding_bytes{category}, pilosa_memory_objects.
        Totals are read under the lock; the stats client (its own lock)
        is called outside it."""
        if stats is None:
            return
        for cat, t in self.totals().items():
            tagged = stats.with_tags(f"category:{cat}")
            tagged.gauge("memory.bytes", t["bytes"])
            tagged.gauge("memory.padding_bytes", t["paddedBytes"])
            tagged.gauge("memory.objects", t["count"])


# The process-wide ledger every allocation site registers with.
LEDGER = MemoryLedger()


class MemoryWatchdog:
    """Every ``sample_every_s`` snapshots the ledger (and caller gauges)
    into a bounded ring, and warns with the top-K device entries when
    device bytes cross ``watermark_bytes``. The warning re-arms once the
    bytes fall below 90 % of the watermark."""

    def __init__(self, ledger: MemoryLedger = LEDGER,
                 logger: Optional[logging.Logger] = None,
                 sample_every_s: float = 10.0,
                 ring: int = 360, watermark_bytes: int = 0,
                 top_k: int = 5,
                 extra_gauges: Optional[Callable[[], Dict[str, Any]]]
                 = None) -> None:
        self.ledger = ledger
        self.logger = logger or _LOG
        self.sample_every_s = max(0.05, float(sample_every_s))
        self.watermark_bytes = int(watermark_bytes)
        self.top_k = top_k
        self.extra_gauges = extra_gauges
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self._ring_lock = threading.RLock()
        self._over_watermark = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0
        self.last_sample_at: Optional[float] = None

    def sample_once(self) -> Dict[str, Any]:
        """One snapshot of the ledger totals and the extra gauges."""
        snap: Dict[str, Any] = {"t": time.time(), "totalBytes": 0,
                                "deviceBytes": 0, "paddingBytes": 0,
                                "categories": {}}
        for cat, t in self.ledger.totals().items():
            snap["categories"][cat] = t["bytes"]
            snap["totalBytes"] += t["bytes"]
            snap["paddingBytes"] += t["paddedBytes"]
            if cat not in HOST_CATEGORIES:
                snap["deviceBytes"] += t["bytes"]
        if self.extra_gauges is not None:
            try:
                snap.update(self.extra_gauges() or {})
            except Exception:
                pass  # a gauge must never stop the sampler
        with self._ring_lock:
            self._ring.append(snap)
            self.samples_taken += 1
            self.last_sample_at = snap["t"]
        self._check_watermark(snap)
        return snap

    def _check_watermark(self, snap: Dict[str, Any]) -> None:
        if self.watermark_bytes <= 0:
            return
        device = snap["deviceBytes"]
        if device >= self.watermark_bytes:
            if not self._over_watermark:
                self._over_watermark = True
                self.logger.warning(
                    "device memory pressure: %d bytes ledgered on the "
                    "device (watermark %d); top banks: %s", device,
                    self.watermark_bytes,
                    self.ledger.top(self.top_k, device_only=True))
        elif device < int(self.watermark_bytes * 0.9):
            self._over_watermark = False

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.sample_every_s):
                try:
                    self.sample_once()
                except Exception:
                    pass  # one bad sample must not end the sampler

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mem-watchdog")
        self._thread.start()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.sample_every_s + 5)
            self._thread = None

    def snapshots(self) -> List[Dict[str, Any]]:
        """Oldest-first copy of the ring."""
        with self._ring_lock:
            return list(self._ring)

    def dump(self, logger: Optional[Any] = None, last: int = 10) -> int:
        """Write the last ``last`` ring snapshots to a ``printf`` logger
        (the shutdown dump); returns how many were written."""
        snaps = self.snapshots()[-max(0, int(last)):]
        if logger is not None and snaps:
            logger.printf("memory watchdog: dumping last %d of %d "
                          "snapshots", len(snaps), self.samples_taken)
            for s in snaps:
                logger.printf("memory watchdog: %s", s)
        return len(snaps)
