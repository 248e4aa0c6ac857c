"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: ``configs/<config>.json`` (its ``kind`` names
``datasets/<kind>.py`` and ``reference/<kind>.py``), ``traffic/<mix>.json``
and ``metrics/<metric>.py``. The harness itself knows none of them.

Set-up (``setup_s``, from the interpreter's start to the window's open):
the dataset from the seed, its bulk import into the port, the port's
server as ``cli server`` builds it (API, coalescer at its default window,
result cache on, HTTP on a free loopback port), the load generator's
process, and the warm-up requests of the cell's own mix. The window: the
load generator sends the mix's requests at its fixed rate from ``open``
to ``close`` (an open loop; ``loadgen.py``). After it: the device
peak, the traced run's probes, the server's shutdown, then the check of
every answer due in the window and of every probe against the plain
reference.
"""

from __future__ import annotations

import gc
import http.client
import importlib
import importlib.util
import json
import os
import queue
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from portbench import devtrace as tracemod
from portbench.gen import Traffic, load_mix
from portbench.peaks import hbm_bytes_per_s
from portbench.pql import parse

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
OPEN_DELAY_S = 0.5  # from the window's announcement to its open
CLIENT_TIMEOUT_S = 60.0
CHILD_WAIT_S = 120.0
# How the harness drives a mix, the same for every mix: a warm-up of
# WARM_CLIENTS closed-loop clients sending WARM_REQUESTS requests each,
# a pool of SENDERS threads for the window's open loop (more than ever
# wait at once below capacity), and PROBES probes in a traced run.
WARM_CLIENTS, WARM_REQUESTS, SENDERS, PROBES = 16, 4, 32, 8
# The traced part of the window: from a quarter of it, for half of it, at
# most TRACE_MAX_S seconds (a steady part: requests arriving, nothing
# warming; long enough to hold the server's slow periods too).
TRACE_LEAD, TRACE_SHARE, TRACE_MAX_S = 0.25, 0.5, 15.0
WINDOW_RANGE = "portbench.window"
PROBE_RANGE = "portbench.probe.{}"


class SetupError(RuntimeError):
    """The cell could not be set up or driven: no result is printed."""


@dataclass
class Env:
    """What a metric's hooks may read of the running program."""
    api: Any
    executor: Any
    coalescer: Any
    host: str
    port: int


@dataclass
class Context:
    """What a metric's ``read`` gets after the run."""
    seconds: float
    records: List[dict]  # every request due in the window
    in_window: List[dict]  # those of them answered by the close
    calls_answered: int
    setup_s: float
    import_s: float
    warm_s: float
    peak_bytes: int
    snaps: Dict[str, tuple] = field(default_factory=dict)
    after: Dict[str, Any] = field(default_factory=dict)
    events: Any = None
    window_ns: Optional[tuple] = None
    probes: List[tuple] = field(default_factory=list)
    hbm_bytes_per_s: Optional[float] = None


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SetupError(f"no {what} named {name!r} in BENCHMARK.json")


def load_file_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SetupError(f"no reader {path.relative_to(ROOT)}")
    return load_file_module(path)


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


class Server:
    """The port's server as ``cli server`` wires it, over ``holder``."""

    def __init__(self, holder):
        from pilosa_tpu_torch.cli.main import build_server, \
            start_cluster_loops, start_monitors
        from pilosa_tpu_torch.utils.config import load_config
        # The defaults, with no file and no environment switch.
        self.cfg = load_config(None, {"bind": "127.0.0.1:0"}, environ={})
        self.api, self.http, self.watchdog = build_server(self.cfg, holder)
        self.loops = start_cluster_loops(self.api, self.cfg) + \
            start_monitors(self.api, self.cfg)
        self.thread = threading.Thread(target=self.http.serve_forever,
                                       name="portbench-http", daemon=True)
        self.thread.start()
        self.host, self.port = self.http.server_address[:2]

    def env(self) -> Env:
        return Env(self.api, self.api.executor, self.api.coalescer,
                   self.host, self.port)

    def stop(self) -> None:
        from pilosa_tpu_torch.cli.main import stop_server
        self.http.shutdown()
        self.thread.join(timeout=30)
        stop_server(self.api, self.http, self.watchdog, self.loops)


class LoadGen:
    """The load generator's process and its output lines."""

    def __init__(self, settings: dict):
        self.proc = subprocess.Popen(
            [sys.executable, str(BENCH_DIR / "loadgen.py")], cwd=str(ROOT),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.lines: "queue.Queue[Optional[str]]" = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.send(settings)

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def send(self, obj: dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def next(self, timeout: float) -> Any:
        line = self.lines.get(timeout=timeout)
        if line is None:
            raise SetupError(f"load generator exited with "
                             f"{self.proc.wait()}")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.reader.join(timeout=10)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _hooks(readers: Dict[str, Any], hook: str, env: Env) -> Dict[str, Any]:
    return {n: getattr(r, hook)(env) for n, r in readers.items()
            if hasattr(r, hook)}


def _send_probes(env: Env, texts: List[str], index: str) -> List[tuple]:
    """Each probe alone, inside a named range that also holds the device
    work it caused. Returns (text, status, body) a probe."""
    import torch
    from torch.profiler import record_function
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    conn = http.client.HTTPConnection(env.host, env.port,
                                      timeout=CLIENT_TIMEOUT_S)
    out = []
    try:
        for i, text in enumerate(texts):
            sync()
            with record_function(PROBE_RANGE.format(i)):
                conn.request("POST", f"/index/{index}/query",
                             body=text.encode())
                resp = conn.getresponse()
                out.append((text, resp.status, resp.read().decode()))
                sync()
    finally:
        conn.close()
    return out


def _results(body: str) -> Optional[list]:
    try:
        return json.loads(body)["results"]
    except (ValueError, KeyError, TypeError):
        return None


def check_answers(reference, records: List[dict]) -> Dict[str, Any]:
    """Every answered request of ``records`` against the reference: those
    compared, those that differ, and those that got no answer."""
    unanswered = [r for r in records if r["status"] != 200
                  or _results(r["body"]) is None]
    gone = {id(r) for r in unanswered}
    answered = [r for r in records if id(r) not in gone]
    want: Dict[str, Any] = {}
    bad = []
    for r in answered:
        if r["pql"] not in want:
            want[r["pql"]] = reference.answer(r["pql"])
        if _results(r["body"]) != want[r["pql"]]:
            bad.append(r)
    return {"compared": len(answered), "mismatched": bad,
            "unanswered": unanswered}


def verdict(checked: Dict[str, Any]):
    """``correct`` and the numbers compared, each beside its limit, of
    what ``check_answers`` found."""
    shown = {
        "mismatched": {"value": len(checked["mismatched"]), "limit": 0},
        "unanswered": {"value": len(checked["unanswered"]), "limit": 0},
        "compared": {"value": checked["compared"], "limit": "at least 1"}}
    correct = not checked["mismatched"] and not checked["unanswered"] \
        and checked["compared"] >= 1
    return correct, shown


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             overrides: Optional[dict] = None, root: Path = ROOT,
             log: Callable[[str], None] = lambda m: print(
                 m, file=sys.stderr, flush=True)) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``overrides`` changes sizes of the configuration (the tests' small
    scale); ``device`` "cpu" runs the port's reference paths (tests)."""
    t0 = time.monotonic() if t0 is None else t0
    bench = load_bench(root)
    wl = _named(bench["workloads"], workload, "workload")
    centry = _named(bench["configs"], wl["config"], "configuration")
    with open(root / centry["file"]) as f:
        cfg = json.load(f)
    cfg.update(overrides or {})
    mix = load_mix(str(BENCH_DIR / "traffic" / f"{wl['traffic']}.json"))
    sizes = {k: v for k, v in cfg.items() if isinstance(v, int)}
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: metric_reader(m["name"]) for m in metrics}
    dataset = importlib.import_module(f"portbench.datasets.{cfg['kind']}")
    refmod = importlib.import_module(f"portbench.reference.{cfg['kind']}")

    import torch
    cuda = device.startswith("cuda")
    data = dataset.generate(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    holder = dataset.load(cfg, data, device)
    import_s = time.monotonic() - t
    log(f"portbench: {workload}: data and import ready at "
        f"{time.monotonic() - t0:.3f} s (import {import_s:.3f} s)")
    server = Server(holder)
    env = server.env()
    gen = None
    try:
        t = time.monotonic()
        gen = LoadGen({"host": env.host, "port": env.port,
                       "index": mix["index"], "seed": seed, "sizes": sizes,
                       "mix": str(BENCH_DIR / "traffic"
                                  / f"{wl['traffic']}.json"),
                       "rate": mix["rate_per_s"],
                       "senders": SENDERS,
                       "warm_clients": WARM_CLIENTS,
                       "warm": WARM_REQUESTS,
                       "timeout": CLIENT_TIMEOUT_S})
        warm = gen.next(timeout=600)["warm"]
        warm_s = time.monotonic() - t
        if warm["n_failed"]:
            raise SetupError(f"warm-up requests failed: {warm['failed']}")
        if cuda:
            torch.cuda.synchronize()
        # Started while the server is idle: a start amid launches in
        # flight has stalled the server until the stop.
        prof = tracemod.start_profiler() if trace else None
        t_open = time.monotonic() + OPEN_DELAY_S
        t_close = t_open + seconds
        gen.send({"open": t_open, "close": t_close})
        setup_s = t_open - t0
        _sleep_until(t_open)
        snap_open = _hooks(readers, "at_window", env)
        events, window_ns = None, None
        if trace:
            _sleep_until(t_open + TRACE_LEAD * seconds)
            from torch.profiler import record_function
            span = (time.monotonic(),
                    time.monotonic() + min(TRACE_SHARE * seconds,
                                           TRACE_MAX_S))
            with record_function(WINDOW_RANGE):
                _sleep_until(span[1])
            prof.stop()
        _sleep_until(t_close)
        snap_close = _hooks(readers, "at_window", env)
        records = []
        while True:
            line = gen.next(timeout=CLIENT_TIMEOUT_S + CHILD_WAIT_S)
            if isinstance(line, dict):
                break
            seq, due, ts, td, status, calls, pql, body = line
            records.append({"seq": seq, "t_due": due, "t_send": ts,
                            "t_done": td, "status": status,
                            "calls": calls, "pql": pql, "body": body})
        gen.proc.wait(timeout=CHILD_WAIT_S)
        if trace:
            log("portbench: requests answered in the traced span: "
                f"{sum(span[0] <= r['t_done'] < span[1] for r in records)}")
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        after, probes, probe_records = {}, [], []
        if trace:
            events = tracemod.Events(prof)
            window_ns = events.range(WINDOW_RANGE)
            log(f"portbench: trace: {events.summary()}; window {window_ns}")
            after = _hooks(readers, "after_window", env)
            probe_records, probes = _probe(env, mix, cfg, data, dataset,
                                           records, sizes, seed, log)
    finally:
        if gen is not None:
            gen.close()
        server.stop()
    del server, env, holder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    in_window = [r for r in records if r["t_done"] <= t_close]
    t = time.monotonic()
    reference = refmod.Reference(cfg, data, device)
    checked = check_answers(reference, records + [
        {"pql": p, "status": s, "body": b, "calls": 0}
        for p, s, b in probe_records])
    del reference
    log(f"portbench: reference checked {checked['compared']} answers in "
        f"{time.monotonic() - t:.3f} s")
    ctx = Context(
        seconds=seconds, records=records, in_window=in_window,
        calls_answered=sum(r["calls"] for r in in_window
                           if r["status"] == 200), setup_s=setup_s,
        import_s=import_s, warm_s=warm_s, peak_bytes=peak,
        snaps={n: (snap_open[n], snap_close[n]) for n in snap_open},
        after=after, events=events, window_ns=window_ns, probes=probes,
        hbm_bytes_per_s=hbm_bytes_per_s(
            torch.cuda.get_device_name(0)) if cuda else None)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(1 for r in records if r["status"] != 200)
    correct, shown = verdict(checked)
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": values,
           "device": device_info(torch, device, peak)}
    if trace and events is not None and window_ns is not None:
        lo, hi = window_ns
        out["device"]["busy_s"] = events.busy_ns(lo, hi) / 1e9
        out["device"]["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = {"device_ops": events.top_ops(lo, hi),
                            "idle_gaps": events.idle_gaps(lo, hi)}
    for r in checked["mismatched"][:3]:
        log(f"portbench: mismatch: {r['pql'][:200]!r} -> "
            f"{r['body'][:300]!r}")
    for r in checked["unanswered"][:3]:
        log(f"portbench: unanswered: status {r['status']}: "
            f"{r['body'][:300]!r}")
    late = [r["t_send"] - r["t_due"] for r in records]
    out["load"] = {"offered_per_s": mix["rate_per_s"],
                   "due": len(records),
                   "answered_by_close": len(in_window),
                   "send_late_p95_ms": float(np.percentile(late, 95)) * 1e3
                   if late else 0.0}
    out["checked"] = shown
    return out


def _probe(env: Env, mix: dict, cfg: dict, data: Any, dataset: Any,
           records: List[dict], sizes: dict, seed: int,
           log: Callable[[str], None]):
    """The traced run's probes: fresh requests of the mix, one at a
    time, under the profiler. Returns their (text, status, body) and
    (least bytes, device seconds) each."""
    traffic = Traffic(mix, sizes, seed)
    sent = set()
    for c in range(WARM_CLIENTS):
        for s in range(WARM_REQUESTS):
            sent.update(traffic.request("warm", c, s)[0].split("\n"))
    for r in records:
        sent.update(r["pql"].split("\n"))
    texts = traffic.probes(sent, PROBES)
    prof = tracemod.start_profiler()
    try:
        answers = _send_probes(env, texts, mix["index"])
    finally:
        prof.stop()
    events = tracemod.Events(prof)
    log(f"portbench: probes' trace: {events.summary()}")
    out = []
    for i, text in enumerate(texts):
        rng = events.range(PROBE_RANGE.format(i))
        if rng is None:
            continue
        out.append((dataset.least_bytes(parse(text), cfg, data),
                    events.device_ns(*rng) / 1e9))
    return answers, out


def device_info(torch, device: str, peak: int) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}


def jax_modules() -> List[str]:
    """Top-level names in ``sys.modules`` of JAX or the JAX package,
    compared whole (``pilosa_tpu_torch`` is not ``pilosa_tpu``)."""
    banned = {"jax", "jaxlib", "flax", "pilosa_tpu"}
    return sorted({m.split(".")[0] for m in sys.modules} & banned)


def env_for_caches(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for every kernel
    cache a library might keep, so only a checkout's first run builds."""
    cache = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
