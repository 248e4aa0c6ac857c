"""``python -m pilosa_tpu_torch.cli``: the port's server, export and
config commands.

    python -m pilosa_tpu_torch.cli server [-c CONFIG.toml] \\
        [--bind HOST:PORT] [--data-dir DIR] [--device cuda|cpu] \\
        [--verbose] [--no-coalescer] [--coalescer-window-ms MS]
    python -m pilosa_tpu_torch.cli export --data-dir DIR --index I \\
        --field F [--shard S] [--output PATH]
    python -m pilosa_tpu_torch.cli config [-c CONFIG.toml]
    python -m pilosa_tpu_torch.cli generate-config

The flags are the JAX package's (``pilosa_tpu/cli/main.py``). ``server``
resolves its settings through ``utils/config.load_config``: flags over
``PILOSA_TPU_*`` variables over the TOML file over defaults, with the
JAX package's keys; a key the port has no counterpart of yet (seed
join, resize and anti-entropy, the mesh, the JAX platform keys) fails at
startup with a message that says so. With ``--data-dir`` (or ``data_dir``) the server
opens ``Holder(DIR)`` (the JAX package's directory layout; either
package opens the other's), and every acknowledged write is in its
files; without it the holder lives in memory. SIGTERM stops the server
like Ctrl-C: the coalescer drains what it admitted, the telemetry is
written to the log (``drain_telemetry``) and the holder closes, which
saves the count caches. The server runs on CUDA unless ``--device cpu``
is given, and raises where there is no card. Port 0 binds a free port;
the first line on stdout names the address served.

The server wires every plane from its config: the profiler and the
slow-query ring, the timeline, the roofline, the workload recorder, the
result and rank caches, the optimizer switch, the sentinel and its
objectives (``[slo]``), the failpoints (``[failpoints]`` or
``PILOSA_TPU_FAILPOINTS``, which also enable ``/internal/failpoints``),
the memory watchdog (whose gauge hook samples the sentinel) and the
hybrid layout's re-layout pass. With ``cluster_peers`` (every node's
URI, this one's among them; the node's id is its URI) the server is one
node of a static cluster of ``cluster_replicas`` replicas: the
coordinator fans queries out, imports go to every owner, the heartbeat
marks dead peers down and the translate replication loop pulls the
primary's key log; ``.topology`` in the data directory keeps the
topology. With ``tls_certificate`` and ``tls_key`` it serves HTTPS, to
clients and peers alike. ``config`` prints the resolved settings as
JSON; ``generate-config`` prints the defaults as TOML.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys


def drain_telemetry(api, watchdog=None) -> None:
    """The telemetry leg of the shutdown, once per API: stop the memory
    watchdog and dump its ring, then the slow-query ring, what the
    workload recorder saw as hot, the last request timelines, the
    roofline's calibration state, the sentinel's budgets and alerts,
    and the finished spans; then stop an exporting tracer (its final
    flush)."""
    from pilosa_tpu_torch.utils.hotspots import WORKLOAD
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    from pilosa_tpu_torch.utils.sentinel import SENTINEL
    from pilosa_tpu_torch.utils.timeline import TIMELINE

    if getattr(api, "_telemetry_drained", False):
        return
    api._telemetry_drained = True
    if watchdog is not None:
        watchdog.stop()
        watchdog.dump(api.logger)
    api.profiler.dump(api.logger)
    if WORKLOAD.enabled:
        WORKLOAD.dump(api.logger)
    if TIMELINE.enabled:
        TIMELINE.dump(api.logger)
    if ROOFLINE.enabled:
        ROOFLINE.dump(api.logger)
    if SENTINEL.enabled:
        SENTINEL.dump(api.logger)
    if hasattr(api.tracer, "dump"):
        api.tracer.dump(api.logger)
    if hasattr(api.tracer, "stop"):
        api.tracer.stop()


def _stats(cfg):
    from pilosa_tpu_torch.utils.stats import MemStatsClient, \
        MultiStatsClient, NopStatsClient, StatsdStatsClient
    if cfg.metric_service == "mem":
        return MemStatsClient()
    if cfg.metric_service == "statsd":
        # Mem rides along so /metrics and /debug/vars keep working.
        return MultiStatsClient(MemStatsClient(),
                                StatsdStatsClient(cfg.metric_host))
    return NopStatsClient()


def _tracer(cfg):
    from pilosa_tpu_torch.utils.tracing import ExportingTracer, \
        RecordingTracer
    if not cfg.tracing_endpoint:
        return RecordingTracer()
    tracer = ExportingTracer(cfg.tracing_endpoint,
                             service_name=cfg.tracing_service_name,
                             sampler_type=cfg.tracing_sampler_type,
                             sampler_param=cfg.tracing_sampler_param)
    tracer.start()
    return tracer


def configure_planes(api, cfg) -> None:
    """Apply the config to the API's profiler and executor and to the
    process-wide planes: timeline, roofline, workload recorder,
    sentinel, failpoints, result and rank caches, optimizer."""
    from pilosa_tpu_torch.core.view import BANK_BUDGET
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.utils.failpoints import FAILPOINTS
    from pilosa_tpu_torch.utils.hotspots import WORKLOAD
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    from pilosa_tpu_torch.utils.sentinel import SENTINEL
    from pilosa_tpu_torch.utils.timeline import TIMELINE

    api.long_query_time = cfg.long_query_time
    api.executor.max_writes_per_request = cfg.max_writes_per_request
    api.profiler.configure(sample_every=cfg.profile_sample_every,
                           ring_size=cfg.profile_slow_ring)
    TIMELINE.configure(enabled=cfg.timeline_enabled,
                       ring=cfg.timeline_ring,
                       sample_every=cfg.timeline_sample_every,
                       gap_window_s=cfg.timeline_gap_window_s)
    ROOFLINE.configure(enabled=cfg.roofline_enabled,
                       gbps=cfg.roofline_gbps,
                       ewma_alpha=cfg.roofline_ewma_alpha,
                       max_cohorts=cfg.roofline_max_cohorts)
    WORKLOAD.configure(enabled=cfg.workload_enabled,
                       half_life_s=cfg.workload_half_life_s,
                       window_s=cfg.workload_window_s,
                       top_k=cfg.workload_top_k,
                       max_fragments=cfg.workload_max_fragments,
                       max_rows=cfg.workload_max_rows,
                       max_signatures=cfg.workload_max_signatures)
    budget = BANK_BUDGET.resolve(api.holder.device)
    SENTINEL.configure(enabled=cfg.sentinel_enabled,
                       ring=cfg.sentinel_ring,
                       decimate=cfg.sentinel_decimate,
                       alert_ring=cfg.sentinel_alert_ring,
                       objectives=cfg.slo,
                       watermark_bytes=int((budget or 0)
                                           * cfg.telemetry_hbm_watermark))
    if cfg.slo:
        api.logger.printf("slo objectives: %s", ", ".join(
            f"{k}: {v}" for k, v in sorted(cfg.slo.items())))
    if cfg.failpoints:
        FAILPOINTS.configure(cfg.failpoints, env="")
        FAILPOINTS.http_enabled = True
        api.logger.printf(
            "failpoints ARMED (test-only surface enabled): %s",
            ", ".join(f"{k}={v}" for k, v in sorted(cfg.failpoints.items())))
    api.executor.result_cache.configure(
        enabled=cfg.cache_result_enabled,
        max_bytes=cfg.cache_result_max_bytes)
    api.holder.rank_cache.configure(
        enabled=cfg.cache_rank_enabled,
        max_entries=cfg.cache_rank_max_entries)
    if not cfg.optimizer_enabled:
        megamod.PLAN_OPT_ENABLED = False


def _start_memory_planes(api, cfg):
    """Start the memory watchdog (its gauge hook samples the sentinel)
    and the layout pass, both with the watermark at
    ``telemetry_hbm_watermark`` of the device budget (none while it is
    unbounded, as on the CPU). Returns the watchdog, or None when
    ``telemetry_sample_every_s`` is 0."""
    from pilosa_tpu_torch.core.view import BANK_BUDGET
    from pilosa_tpu_torch.utils.memledger import LEDGER, MemoryWatchdog

    budget = BANK_BUDGET.resolve(api.holder.device)
    watermark = int(budget * cfg.telemetry_hbm_watermark) if budget else 0
    watchdog = None
    if cfg.telemetry_sample_every_s > 0:
        def gauges():
            try:
                api.sample_sentinel()
            except Exception:
                pass  # a sentinel fault must not stop the watchdog
            coal = api.coalescer
            return {"queueDepth": coal.queue_depth()
                    if coal is not None else 0}

        watchdog = MemoryWatchdog(
            LEDGER, sample_every_s=cfg.telemetry_sample_every_s,
            ring=cfg.telemetry_ring, watermark_bytes=watermark,
            extra_gauges=gauges)
        watchdog.start()
        api.watchdog = watchdog
    api.layout.configure(
        enabled=cfg.layout_enabled, interval_s=cfg.layout_interval_s,
        demote_density=cfg.layout_demote_density,
        min_bytes=cfg.layout_min_bytes,
        promote_rate=cfg.layout_promote_rate, watermark_bytes=watermark)
    if cfg.layout_enabled and cfg.layout_interval_s > 0:
        api.layout.start()
    return watchdog


def build_cluster(cfg, holder):
    """The static cluster of ``cfg.cluster_peers`` with this node among
    them, its ``.topology`` read back from the data directory (none in
    memory); None without peers."""
    from pilosa_tpu_torch.parallel.cluster import STATE_NORMAL, Cluster, \
        Node
    if not cfg.cluster_peers:
        return None
    local_uri = cfg.advertise or f"{cfg.scheme}://{cfg.bind}"
    cluster = Cluster(
        Node(local_uri, local_uri,
             is_coordinator=local_uri == sorted(cfg.cluster_peers)[0]),
        replica_n=cfg.cluster_replicas,
        topology_path=(os.path.join(holder.path, ".topology")
                       if holder.path else None))
    for peer in cfg.cluster_peers:
        if peer != local_uri:
            cluster.add_node(Node(peer, peer))
    cluster.load()
    cluster.set_state(STATE_NORMAL)
    return cluster


def start_cluster_loops(api, cfg):
    """The heartbeat and the translate replication loop of a cluster
    node (each off at an interval of 0); returns them."""
    from pilosa_tpu_torch.parallel.heartbeat import Heartbeater, \
        TranslateReplicationLoop
    loops = []
    if api.cluster is None:
        return loops
    if cfg.heartbeat_interval > 0:
        hb = Heartbeater(api.cluster, interval=cfg.heartbeat_interval,
                         suspect_after=cfg.heartbeat_suspect,
                         probes_per_round=cfg.heartbeat_probes,
                         logger=api.logger,
                         ssl_context=cfg.client_ssl_context())
        hb.start()
        loops.append(hb)
    if cfg.translate_replication_interval > 0:
        tr = TranslateReplicationLoop(api,
                                      cfg.translate_replication_interval)
        tr.start()
        loops.append(tr)
    return loops


def build_server(cfg, holder):
    """The server of ``cfg`` over ``holder``: the API with its stats
    client, tracer and cluster, every plane configured, the coalescer
    and the memory planes started, and the HTTP server bound (not yet
    serving), over TLS when configured. Returns (api, server,
    watchdog); ``stop_server`` undoes it."""
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    from pilosa_tpu_torch.server.http import make_server

    api = API(holder, stats=_stats(cfg), tracer=_tracer(cfg),
              cluster=build_cluster(cfg, holder),
              client_ssl_context=cfg.client_ssl_context())
    configure_planes(api, cfg)
    if api.cluster_executor is not None:
        api.cluster_executor.configure(
            fanout_deadline_s=cfg.cluster_fanout_deadline_s,
            backoff_base_s=cfg.cluster_backoff_base_s,
            backoff_cap_s=cfg.cluster_backoff_cap_s,
            hedge_quantile=cfg.cluster_hedge_quantile)
        api._client.configure(timeout=cfg.cluster_rpc_timeout_s,
                              health_timeout=cfg.cluster_health_timeout_s)
    if cfg.coalescer_enabled:
        api.coalescer = QueryCoalescer(
            api.executor, window_s=cfg.coalescer_window_ms / 1e3,
            max_batch=cfg.coalescer_max_batch,
            max_queue=cfg.coalescer_max_queue,
            deadline_s=cfg.coalescer_deadline_ms / 1e3,
            stats=api.stats, tracer=api.tracer,
            pipeline=cfg.coalescer_pipeline)
        api.coalescer.start()
    watchdog = _start_memory_planes(api, cfg)
    return api, make_server(api, cfg.host, cfg.port,
                            ssl_context=cfg.server_ssl_context()), watchdog


def stop_server(api, server, watchdog, loops=()) -> None:
    """The shutdown: stop the cluster loops and the broadcaster, drain
    the coalescer, stop the layout pass, write the telemetry to the log,
    close the listener."""
    for loop in loops:
        loop.stop()
    if api.broadcaster is not None:
        api.broadcaster.stop()
    if api.coalescer is not None:
        api.coalescer.stop()
    api.layout.stop()
    drain_telemetry(api, watchdog=watchdog)
    server.server_close()
    if hasattr(api.stats, "flush"):
        api.stats.flush()


def cmd_server(args) -> int:
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, {
        "data_dir": args.data_dir, "bind": args.bind,
        "verbose": args.verbose or None,
        "coalescer_enabled": False if args.no_coalescer else None,
        "coalescer_window_ms": args.coalescer_window_ms,
    })
    logging.basicConfig(level=logging.DEBUG if cfg.verbose
                        else logging.INFO)
    holder = Holder(os.path.expanduser(cfg.data_dir) if cfg.data_dir
                    else None, device=args.device)
    if holder.path is not None:
        holder.open()
    api, server, watchdog = build_server(cfg, holder)
    loops = start_cluster_loops(api, cfg)

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    addr = server.server_address
    coal = "off" if api.coalescer is None \
        else f"{cfg.coalescer_window_ms:g} ms"
    nodes = "" if api.cluster is None else \
        f" cluster={len(api.cluster.nodes())} nodes" \
        f" replicas={api.cluster.replica_n}"
    print(f"pilosa-tpu-torch server listening on "
          f"{cfg.scheme}://{addr[0]}:{addr[1]}"
          f" device={holder.device} coalescer={coal}"
          f" data_dir={holder.path or '(memory)'}{nodes}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop_server(api, server, watchdog, loops)
        if holder.path is not None:
            holder.close()
    return 0


def cmd_config(args) -> int:
    from dataclasses import asdict

    from pilosa_tpu_torch.utils.config import load_config
    print(json.dumps(asdict(load_config(args.config, {})), indent=2))
    return 0


def cmd_generate_config(args) -> int:
    from pilosa_tpu_torch.utils.config import Config
    print(Config().to_toml(), end="")
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
    sp.add_argument("-b", "--bind", default=None,
                    help="HOST:PORT to listen on (port 0: any free port; "
                         "default localhost:10101)")
    sp.add_argument("-c", "--config", default=None,
                    help="TOML config file")
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu to run without "
                         "a card)")
    sp.add_argument("--no-coalescer", action="store_true",
                    help="serve every query on the direct path "
                         "(disable cross-request coalescing)")
    sp.add_argument("--coalescer-window-ms", type=float, default=None,
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
    gp = sub.add_parser("config", help="print resolved configuration")
    gp.add_argument("-c", "--config", default=None)
    gp.set_defaults(fn=cmd_config)
    gg = sub.add_parser("generate-config",
                        help="print default TOML config")
    gg.set_defaults(fn=cmd_generate_config)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
