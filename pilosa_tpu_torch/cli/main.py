"""``python -m pilosa_tpu_torch.cli``: the port's server and export.

    python -m pilosa_tpu_torch.cli server --bind HOST:PORT \\
        [--data-dir DIR] [--device cuda|cpu] [--no-coalescer] \\
        [--coalescer-window-ms MS]
    python -m pilosa_tpu_torch.cli export --data-dir DIR --index I \\
        --field F [--shard S] [--output PATH]

The flags are the JAX package's (``pilosa_tpu/cli/main.py``). With
``--data-dir`` the server opens ``Holder(DIR)`` (the JAX package's
directory layout; either package opens the other's), and every
acknowledged write is in its files; without it the holder lives in
memory. SIGTERM stops the server like Ctrl-C: the coalescer drains what
it admitted and the holder closes, which saves the count caches. The
server runs on CUDA unless ``--device cpu`` is given, and raises where
there is no card. Port 0 binds a free port; the first line on stdout
names the address served. The server also runs the memory watchdog and
the hybrid layout's re-layout pass with the JAX package's config
defaults (a 10 s sample, a ring of 360, every 30 s, the watermark at 0.9
of the device budget). ``export`` writes one field's standard view as
``row,col`` CSV, every shard or one. No TOML config.

The server keeps its metrics in memory (``/metrics``, ``/debug/vars``)
and records spans in process. Until the config module is ported, the
measurement plane reads the JAX package's environment names
(``measurement_settings``): ``PILOSA_TPU_PROFILE_SAMPLE_EVERY`` (fence 1
in N queries for device time; 0, the default, only ``?profile=true``),
``PILOSA_TPU_PROFILE_SLOW_RING``, ``PILOSA_TPU_LONG_QUERY_TIME``
(seconds), ``PILOSA_TPU_TIMELINE_{ENABLED,RING,SAMPLE_EVERY,
GAP_WINDOW_S}`` and ``PILOSA_TPU_ROOFLINE_{ENABLED,GBPS,EWMA_ALPHA,
MAX_COHORTS}`` (``GBPS`` 0 resolves the card's own figure). At shutdown
the slow-query ring, the last timelines, the roofline's state and the
spans are written to the log (``drain_telemetry``).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys


def _bind(bind: str):
    host, _, port = bind.rpartition(":")
    if not port.isdigit():
        raise SystemExit(f"--bind wants HOST:PORT, got {bind!r}")
    return host or "localhost", int(port)


# The JAX package's server defaults (utils/config.py): the watchdog's
# sample period, ring and watermark share of the device budget, and the
# layout pass's period, demotion density, least bank and promotion rate.
TELEMETRY_SAMPLE_EVERY_S = 10.0
TELEMETRY_RING = 360
WATERMARK_SHARE = 0.9
LAYOUT_INTERVAL_S = 30.0
LAYOUT_DEMOTE_DENSITY = 0.25
LAYOUT_MIN_BYTES = 1 << 20
LAYOUT_PROMOTE_RATE = 0.5


# The JAX package's config defaults of the measurement plane
# (utils/config.py), by the field name its PILOSA_TPU_* variable spells.
MEASUREMENT_DEFAULTS = {
    "profile_sample_every": 0,
    "profile_slow_ring": 128,
    "long_query_time": 0.0,
    "timeline_enabled": True,
    "timeline_ring": 256,
    "timeline_sample_every": 1,
    "timeline_gap_window_s": 60.0,
    "roofline_enabled": True,
    "roofline_gbps": 0.0,
    "roofline_ewma_alpha": 0.25,
    "roofline_max_cohorts": 256,
}


def measurement_settings(env=None) -> dict:
    """The measurement plane's settings: each default overridden by its
    ``PILOSA_TPU_<NAME>`` variable, parsed as the JAX package's config
    parses it (a bool is on for 1, true or yes)."""
    env = os.environ if env is None else env
    out = dict(MEASUREMENT_DEFAULTS)
    for k, cur in MEASUREMENT_DEFAULTS.items():
        v = env.get("PILOSA_TPU_" + k.upper())
        if v is None:
            continue
        if isinstance(cur, bool):
            out[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            out[k] = int(v)
        else:
            out[k] = float(v)
    return out


def configure_measurement(api, settings: dict) -> None:
    """Apply ``measurement_settings`` to the API's profiler and the
    process-wide timeline and roofline recorders."""
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    from pilosa_tpu_torch.utils.timeline import TIMELINE

    api.long_query_time = settings["long_query_time"]
    api.profiler.configure(sample_every=settings["profile_sample_every"],
                           ring_size=settings["profile_slow_ring"])
    TIMELINE.configure(enabled=settings["timeline_enabled"],
                       ring=settings["timeline_ring"],
                       sample_every=settings["timeline_sample_every"],
                       gap_window_s=settings["timeline_gap_window_s"])
    ROOFLINE.configure(enabled=settings["roofline_enabled"],
                       gbps=settings["roofline_gbps"],
                       ewma_alpha=settings["roofline_ewma_alpha"],
                       max_cohorts=settings["roofline_max_cohorts"])


def drain_telemetry(api) -> None:
    """The telemetry leg of the shutdown: dump the profiler's slow-query
    ring, the last request timelines, the roofline's calibration state
    and the finished spans to the log, then stop an exporting tracer
    (its final flush). Runs once per API."""
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    from pilosa_tpu_torch.utils.timeline import TIMELINE

    if getattr(api, "_telemetry_drained", False):
        return
    api._telemetry_drained = True
    api.profiler.dump(api.logger)
    if TIMELINE.enabled:
        TIMELINE.dump(api.logger)
    if ROOFLINE.enabled:
        ROOFLINE.dump(api.logger)
    if hasattr(api.tracer, "dump"):
        api.tracer.dump(api.logger)
    if hasattr(api.tracer, "stop"):
        api.tracer.stop()


def _start_memory_planes(api) -> None:
    """Start the memory watchdog and the layout pass with the watermark
    at WATERMARK_SHARE of the device budget (none while it is
    unbounded, as on the CPU)."""
    from pilosa_tpu_torch.core.view import BANK_BUDGET
    from pilosa_tpu_torch.utils.memledger import LEDGER, MemoryWatchdog

    budget = BANK_BUDGET.resolve(api.holder.device)
    watermark = int(budget * WATERMARK_SHARE) if budget else 0
    coal = api.coalescer
    api.watchdog = MemoryWatchdog(
        LEDGER, sample_every_s=TELEMETRY_SAMPLE_EVERY_S,
        ring=TELEMETRY_RING, watermark_bytes=watermark,
        extra_gauges=lambda: {
            "queueDepth": coal.queue_depth() if coal is not None else 0})
    api.watchdog.start()
    api.layout.configure(
        enabled=True, interval_s=LAYOUT_INTERVAL_S,
        demote_density=LAYOUT_DEMOTE_DENSITY, min_bytes=LAYOUT_MIN_BYTES,
        promote_rate=LAYOUT_PROMOTE_RATE, watermark_bytes=watermark)
    api.layout.start()


def cmd_server(args) -> int:
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    from pilosa_tpu_torch.server.http import make_server
    from pilosa_tpu_torch.utils.stats import MemStatsClient
    from pilosa_tpu_torch.utils.tracing import RecordingTracer

    host, port = _bind(args.bind)
    holder = Holder(None if args.data_dir is None
                    else os.path.expanduser(args.data_dir),
                    device=args.device)
    if holder.path is not None:
        holder.open()
    api = API(holder, stats=MemStatsClient(), tracer=RecordingTracer())
    configure_measurement(api, measurement_settings())
    if not args.no_coalescer:
        api.coalescer = QueryCoalescer(
            api.executor, window_s=args.coalescer_window_ms / 1e3,
            stats=api.stats, tracer=api.tracer)
        api.coalescer.start()
    _start_memory_planes(api)
    server = make_server(api, host, port)

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    addr = server.server_address
    coal = "off" if api.coalescer is None \
        else f"{args.coalescer_window_ms:g} ms"
    print(f"pilosa-tpu-torch server listening on http://{addr[0]}:{addr[1]}"
          f" device={holder.device} coalescer={coal}"
          f" data_dir={holder.path or '(memory)'}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if api.coalescer is not None:
            api.coalescer.stop()
        drain_telemetry(api)
        api.layout.stop()
        api.watchdog.stop()
        server.server_close()
        if holder.path is not None:
            holder.close()
    return 0


def cmd_export(args) -> int:
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.server.api import export_fragment_lines

    holder = Holder(os.path.expanduser(args.data_dir), device=args.device)
    holder.open()
    try:
        idx = holder.index(args.index)
        f = idx.field(args.field) if idx is not None else None
        if f is None:
            print(f"not found: {args.index}/{args.field}", file=sys.stderr)
            return 1
        view = f.view()
        shards = [args.shard] if args.shard is not None \
            else (view.available_shards() if view else [])
        out = sys.stdout if args.output == "-" else open(args.output, "w")
        try:
            for shard in shards:
                for line in export_fragment_lines(idx, args.field, shard):
                    out.write(line)
        finally:
            if out is not sys.stdout:
                out.close()
    finally:
        holder.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pilosa-tpu-torch",
        description="The PyTorch/CUDA port of the bitmap index.")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("server", help="run the server")
    sp.add_argument("-d", "--data-dir", default=None,
                    help="data directory (default: in memory)")
    sp.add_argument("-b", "--bind", default="localhost:10101",
                    help="HOST:PORT to listen on (port 0: any free port)")
    sp.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu to run without "
                         "a card)")
    sp.add_argument("--no-coalescer", action="store_true",
                    help="serve every query on the direct path "
                         "(disable cross-request coalescing)")
    sp.add_argument("--coalescer-window-ms", type=float, default=1.5,
                    help="coalescer batching window in milliseconds")
    sp.set_defaults(fn=cmd_server)
    ep = sub.add_parser("export", help="export a field as CSV")
    ep.add_argument("-d", "--data-dir", required=True)
    ep.add_argument("-i", "--index", required=True)
    ep.add_argument("-f", "--field", required=True)
    ep.add_argument("--shard", type=int, default=None,
                    help="one shard (default: every shard)")
    ep.add_argument("-o", "--output", default="-")
    ep.add_argument("--device", default=None,
                    help="torch device of the holder (default cuda; cpu "
                         "to run without a card)")
    ep.set_defaults(fn=cmd_export)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
