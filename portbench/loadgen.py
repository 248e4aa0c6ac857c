"""The load generator: an open loop at a fixed rate, in a process apart
from the server's, so that its interpreter lock is not the server's.

It reads its settings as one JSON line on standard input. The warm-up is
closed-loop: ``warm_clients`` threads each send ``warm`` requests of the
warm stream, one at a time. It prints ``{"warm": ...}`` and reads one
more line ``{"open": t, "close": t}`` (``time.monotonic()`` seconds).

The window: ``rate`` requests a second are due between ``open`` and
``close``, whatever the answers do. Their due times are one schedule
for every seed, the quantiles of the exponential distribution of mean
1/rate, in one fixed order, scaled to fill the window: the arrivals of
independent users, and the same arrivals in every run, so that runs of
different seeds differ only in the requests sent. A pool of ``senders``
threads, each with a keep-alive connection, sends each request when it
is due (late when every sender is busy). It then prints one JSON line a
request due in the window, ``[seq, t_due, t_send, t_done, status,
calls, pql, body]``, and ``{"end": true}``.
"""

from __future__ import annotations

import http.client
import json
import math
import os
import sys
import threading
import time

import numpy as np

# The checkout's root in place of this script's folder, whose module
# names would shadow the standard library's.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.gen import Traffic, load_mix  # noqa: E402

ARRIVAL_ORDER = 4  # the seed of the one order of the window's gaps


class Client:
    def __init__(self, host: str, port: int, path: str, timeout: float):
        self.host, self.port, self.path = host, port, path
        self.timeout = timeout
        self.conn = None

    def post(self, body: str):
        """(status, body text); status 0 when no answer came."""
        try:
            if self.conn is None:
                self.conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout)
            self.conn.request("POST", self.path, body=body.encode(),
                              headers={"Content-Type": "text/plain"})
            resp = self.conn.getresponse()
            return resp.status, resp.read().decode()
        except (OSError, http.client.HTTPException) as e:
            self.close()
            return 0, f"{type(e).__name__}: {e}"

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """Due times (from the window's open) of the requests of one window,
    the same for every seed. The last gap would end at the close, so it
    is not sent."""
    n = max(2, int(math.ceil(round(rate * seconds, 6))))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    order = np.random.default_rng(ARRIVAL_ORDER).permutation(n)
    return np.cumsum(gaps[order])[:-1]


def run_threads(n: int, target) -> None:
    threads = [threading.Thread(target=target, args=(c,), daemon=True)
               for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def main() -> int:
    s = json.loads(sys.stdin.readline())
    traffic = Traffic(load_mix(s["mix"]), s["sizes"], s["seed"])
    path = f"/index/{s['index']}/query"

    def client() -> Client:
        return Client(s["host"], s["port"], path, s["timeout"])

    warm_failed = []

    def warm(c: int) -> None:
        cl = client()
        for seq in range(s["warm"]):
            status, body = cl.post(traffic.request("warm", c, seq)[0])
            if status != 200:
                warm_failed.append((status, body[:300]))
        cl.close()

    t0 = time.monotonic()
    run_threads(s["warm_clients"], warm)
    print(json.dumps({"warm": {"s": time.monotonic() - t0,
                               "failed": warm_failed[:5],
                               "n_failed": len(warm_failed)}}), flush=True)

    window = json.loads(sys.stdin.readline())
    due = window["open"] + arrivals(s["rate"], window["close"]
                                    - window["open"])
    texts = [traffic.request("window", 0, i) for i in range(len(due))]
    records = [None] * len(due)
    lock = threading.Lock()
    nxt = [0]

    def sender(_: int) -> None:
        cl = client()
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(due):
                break
            time.sleep(max(0.0, due[i] - time.monotonic()))
            t_send = time.monotonic()
            status, body = cl.post(texts[i][0])
            records[i] = [i, float(due[i]), t_send, time.monotonic(),
                          status, texts[i][1], texts[i][0], body]
        cl.close()

    run_threads(s["senders"], sender)
    out = sys.stdout
    for r in records:
        out.write(json.dumps(r) + "\n")
    out.write(json.dumps({"end": True}) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
