"""The server's logger, after the JAX package's ``utils/logger.py``:
``printf`` and ``debugf`` (the latter only with ``verbose``), one
timestamped line each on a stream (stderr by default); ``NopLogger``
drops everything."""

from __future__ import annotations

import sys
import time


class Logger:
    def __init__(self, stream=None, verbose: bool = False):
        self.stream = stream or sys.stderr
        self.verbose = verbose

    def _emit(self, level: str, msg: str) -> None:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        print(f"{ts} {level} {msg}", file=self.stream, flush=True)

    def printf(self, fmt: str, *args) -> None:
        self._emit("INFO", fmt % args if args else fmt)

    def debugf(self, fmt: str, *args) -> None:
        if self.verbose:
            self._emit("DEBUG", fmt % args if args else fmt)


class NopLogger(Logger):
    def printf(self, fmt, *args):
        pass

    def debugf(self, fmt, *args):
        pass


# The logger of components given none (a fragment's torn-tail warning);
# each API makes its own.
default_logger = Logger()
