"""Diagnostics reports and the runtime monitor, after the JAX package's
``utils/diagnostics.py``.

``DiagnosticsCollector`` POSTs an anonymous JSON report (the version,
the host's OS, architecture, Python version and CPU count, the schema's
index and field counts, and whatever ``set`` added; never data or keys)
every ``interval`` seconds to ``url``. It is off unless both are set,
and a report that cannot be delivered is dropped (``flush`` returns
False, the logger's ``debugf`` says why). ``check_version`` compares a
reported release with the port's ``__version__``.

``RuntimeMonitor`` samples the process into the stats client every
``interval`` seconds: the gauges ``threads``, ``tailDroppedBytes`` (the
holder's torn op-log tails), ``gcGen0``, ``garbageCollection``,
``heapInuse`` (resident bytes) and ``openFiles``, the JAX package's
set. ``cli server`` starts both from ``diagnostics_url`` /
``diagnostics_interval`` and ``metric_poll_interval``.
"""

from __future__ import annotations

import gc
import json
import os
import platform
import threading
import urllib.request
from typing import Any, Dict, Optional

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.utils.locks import make_lock


class DiagnosticsCollector:
    """Periodic anonymous usage report: ``set`` adds fields, ``flush``
    POSTs one report, ``start`` flushes every ``interval`` seconds on a
    thread. Inert without both ``url`` and ``interval``."""

    def __init__(self, url: str = "", interval: float = 0.0,
                 holder=None, logger=None):
        self.url = url
        self.interval = interval
        self.holder = holder
        self.logger = logger
        self._fields: Dict[str, Any] = {}
        self._lock = make_lock("DiagnosticsCollector._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.server_version: Optional[str] = None

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            self._fields[name] = value

    def enabled(self) -> bool:
        return bool(self.url) and self.interval > 0

    def payload(self) -> Dict[str, Any]:
        """The report body: the fields set, then Version, OS, Arch,
        PythonVersion and NumCPU, and with a holder NumIndexes and
        NumFields."""
        with self._lock:
            fields = dict(self._fields)
        fields.update({
            "Version": __version__,
            "OS": platform.system(),
            "Arch": platform.machine(),
            "PythonVersion": platform.python_version(),
            "NumCPU": os.cpu_count(),
        })
        if self.holder is not None:
            schema = self.holder.schema()
            fields["NumIndexes"] = len(schema)
            fields["NumFields"] = sum(len(ix.get("fields", []))
                                      for ix in schema)
        return fields

    def flush(self) -> bool:
        """POST one report; True when it was delivered. Never raises."""
        if not self.url:
            return False
        try:
            body = json.dumps(self.payload()).encode("utf-8")
            req = urllib.request.Request(
                self.url, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10):
                pass
            return True
        except Exception as e:  # noqa: BLE001 - a report is best effort
            if self.logger is not None:
                self.logger.debugf("diagnostics flush failed: %r", e)
            return False

    def check_version(self, latest: str) -> Optional[str]:
        """A message when ``latest`` (a reported release, ``v`` prefix
        and ``-suffix`` allowed) is newer than this build; None when it
        is not or does not parse."""
        self.server_version = latest
        try:
            ours = [int(x) for x in __version__.split("-")[0]
                    .lstrip("v").split(".")]
            theirs = [int(x) for x in latest.split("-")[0]
                      .lstrip("v").split(".")]
        except ValueError:
            return None
        if theirs > ours:
            return (f"an update is available: {latest} "
                    f"(running {__version__})")
        return None

    def start(self) -> None:
        if not self.enabled() or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="diagnostics")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.flush()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class RuntimeMonitor:
    """Samples the process's gauges into ``stats`` every ``interval``
    seconds on a thread (``sample`` takes one round)."""

    def __init__(self, stats, interval: float = 10.0, holder=None):
        self.stats = stats
        self.interval = interval
        self.holder = holder
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> None:
        self.stats.gauge("threads", threading.active_count())
        if self.holder is not None:
            self.stats.gauge("tailDroppedBytes",
                             self.holder.tail_dropped_bytes())
        self.stats.gauge("gcGen0", gc.get_count()[0])
        self.stats.gauge("garbageCollection",
                         gc.get_stats()[-1].get("collections", 0))
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        self.stats.gauge("heapInuse",
                                         int(line.split()[1]) * 1024)
                        break
        except OSError:
            pass
        try:
            self.stats.gauge("openFiles", len(os.listdir("/proc/self/fd")))
        except OSError:
            pass

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="runtime-monitor")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 - monitoring must not crash
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
