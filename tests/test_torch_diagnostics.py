"""The port's diagnostics reports and runtime monitor
(``pilosa_tpu_torch/utils/diagnostics.py``) and logger
(``utils/logger.py``) against the JAX package's: inert by default, the
report's keys and schema counts over the same schema, a POST to a
loopback listener, an unreachable endpoint survived, the version check's
verdicts, the monitor's gauges, and the logger's lines and verbose
gate."""

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.utils import diagnostics as jdiag
from pilosa_tpu.utils import logger as jlogger
from pilosa_tpu.utils.stats import MemStatsClient as JaxMemStats
from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.utils import diagnostics as tdiag
from pilosa_tpu_torch.utils import logger as tlogger
from pilosa_tpu_torch.utils.stats import MemStatsClient

MODS = [pytest.param(jdiag, id="jax"), pytest.param(tdiag, id="port")]


def test_disabled_by_default():
    for mod in (jdiag, tdiag):
        d = mod.DiagnosticsCollector()
        assert not d.enabled()
        assert d.flush() is False
        assert not mod.DiagnosticsCollector(url="http://x").enabled()
        assert not mod.DiagnosticsCollector(interval=5).enabled()
        assert mod.DiagnosticsCollector(url="http://x", interval=5).enabled()


def test_payload_matches_jax(tmp_path):
    """Over the same schema the reports carry the same keys and the same
    values but the version."""
    holders = [JaxHolder(str(tmp_path / "j")), Holder(device="cpu")]
    holders[0].open()
    for h in holders:
        idx = h.create_index("d1")
        idx.create_field("f1")
        idx.create_field("f2")
        h.create_index("d2").create_field("g")
    got = []
    for mod, h in zip((jdiag, tdiag), holders):
        d = mod.DiagnosticsCollector(holder=h)
        d.set("ClusterID", "abc")
        got.append(d.payload())
    j, t = got
    assert set(t) == set(j)
    assert t["Version"] and t["OS"] and t["ClusterID"] == "abc"
    assert t["NumIndexes"] == 2 and t["NumFields"] >= 3
    assert {k: v for k, v in t.items() if k != "Version"} == \
        {k: v for k, v in j.items() if k != "Version"}
    holders[0].close()


def _listener(received):
    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize("mod", MODS)
def test_flush_posts_json(mod):
    received = []
    srv = _listener(received)
    try:
        d = mod.DiagnosticsCollector(
            url=f"http://127.0.0.1:{srv.server_port}/diagnostics")
        assert d.flush() is True
        assert received and received[0]["Version"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_start_posts_on_its_interval_and_stops():
    received = []
    srv = _listener(received)
    try:
        d = tdiag.DiagnosticsCollector(
            url=f"http://127.0.0.1:{srv.server_port}/d", interval=0.05,
            holder=Holder(device="cpu"))
        d.start()
        d.start()  # a second start is a no-op
        deadline = threading.Event()
        for _ in range(200):
            if len(received) >= 2:
                break
            deadline.wait(0.02)
        d.stop()
        n = len(received)
        assert n >= 2 and received[0]["NumIndexes"] == 0
        deadline.wait(0.15)
        assert len(received) == n
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("mod", MODS)
def test_flush_survives_unreachable_endpoint(mod):
    lines = io.StringIO()
    log = (jlogger if mod is jdiag else tlogger).Logger(lines, verbose=True)
    d = mod.DiagnosticsCollector(url="http://127.0.0.1:1/nope", logger=log)
    assert d.flush() is False
    assert "diagnostics flush failed" in lines.getvalue()


@pytest.mark.parametrize("latest", ["v9.9.9", "0.0.1", "garbage", "0.1.0",
                                    "v0.1.1-rc1", "1"])
def test_check_version_matches_jax(latest):
    t = tdiag.DiagnosticsCollector()
    msg = t.check_version(latest)
    assert t.server_version == latest
    want = jdiag.DiagnosticsCollector().check_version(latest)
    assert (msg is None) == (want is None)
    if msg is not None:
        assert msg == want.replace(jdiag.__version__, tdiag.__version__)


def test_runtime_monitor_samples_the_jax_gauges(tmp_path):
    got = []
    for mod, stats, h in ((jdiag, JaxMemStats(), JaxHolder(str(tmp_path))),
                          (tdiag, MemStatsClient(), Holder(device="cpu"))):
        mod.RuntimeMonitor(stats, interval=1000, holder=h).sample()
        got.append(stats.snapshot()["gauges"])
    assert set(got[1]) == set(got[0]) == {
        "threads", "tailDroppedBytes", "gcGen0", "garbageCollection",
        "heapInuse", "openFiles"}
    assert got[1]["threads"] >= 1 and got[1]["heapInuse"] > 0
    assert got[1]["tailDroppedBytes"] == 0


def test_runtime_monitor_loop_starts_and_stops():
    stats = MemStatsClient()
    mon = tdiag.RuntimeMonitor(stats, interval=0.02)
    mon.start()
    for _ in range(200):
        if "openFiles" in stats.snapshot()["gauges"]:
            break
        threading.Event().wait(0.02)
    mon.stop()
    assert "openFiles" in stats.snapshot()["gauges"]
    assert mon._thread is None


@pytest.mark.parametrize("verbose", [False, True])
def test_logger_lines_match_jax(verbose):
    out = []
    for mod in (jlogger, tlogger):
        buf = io.StringIO()
        log = mod.Logger(buf, verbose=verbose)
        log.printf("plain")
        log.printf("n=%d s=%s", 3, "x")
        log.debugf("dbg %s", "y")
        mod.NopLogger(buf).printf("never")
        out.append([ln.split(" ", 1)[1] for ln in
                    buf.getvalue().splitlines()])
    assert out[0] == out[1]
    assert out[1][:2] == ["INFO plain", "INFO n=3 s=x"]
    assert ("DEBUG dbg y" in out[1]) == verbose
