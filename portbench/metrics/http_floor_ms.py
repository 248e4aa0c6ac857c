"""Median round trip of ``GET /version`` on one keep-alive connection,
200 of them after the window: what the HTTP routes cost a request with
no query in it."""

import http.client
import time

import numpy as np

N = 200


def after_window(env):
    conn = http.client.HTTPConnection(env.host, env.port, timeout=30)
    times = []
    try:
        for _ in range(N):
            t = time.monotonic()
            conn.request("GET", "/version")
            resp = conn.getresponse()
            resp.read()
            times.append(time.monotonic() - t)
            if resp.status != 200:
                return None
    finally:
        conn.close()
    return times


def read(ctx):
    times = ctx.after.get("http_floor_ms")
    return float(np.median(times)) * 1e3 if times else None
