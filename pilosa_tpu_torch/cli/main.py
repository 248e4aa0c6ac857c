"""``python -m pilosa_tpu_torch.cli``: the port's commands.

    python -m pilosa_tpu_torch.cli server [-c CONFIG.toml] \\
        [--bind HOST:PORT] [--data-dir DIR] [--device cuda|cpu] \\
        [--platform cuda|gpu|cpu] [--verbose] [--no-coalescer] \\
        [--coalescer-window-ms MS]
    python -m pilosa_tpu_torch.cli import (-d DIR | --host URL) -i I -f F \\
        [--field-type set|int] [--tls-skip-verify] [--device cpu] CSV...
    python -m pilosa_tpu_torch.cli export --data-dir DIR --index I \\
        --field F [--shard S] [--output PATH]
    python -m pilosa_tpu_torch.cli check FILE...
    python -m pilosa_tpu_torch.cli inspect [--verbose] FILE...
    python -m pilosa_tpu_torch.cli backup -d DIR -o OUT.tar.gz
    python -m pilosa_tpu_torch.cli restore -d DIR -i IN.tar.gz [--force]
    python -m pilosa_tpu_torch.cli fold [--force] FILE...
    python -m pilosa_tpu_torch.cli config [-c CONFIG.toml]
    python -m pilosa_tpu_torch.cli generate-config

The flags, messages and exit codes are the JAX package's
(``pilosa_tpu/cli/main.py``). ``server`` resolves its settings through
``utils/config.load_config``: flags over ``PILOSA_TPU_*`` variables over
the TOML file over defaults, with the JAX package's keys. With
``--data-dir`` (or ``data_dir``) the server opens ``Holder(DIR)`` (the
JAX package's directory layout; either package opens the other's), and
every acknowledged write is in its files; without it the holder lives in
memory. SIGTERM stops the server like Ctrl-C: the coalescer drains what
it admitted, the telemetry is written to the log (``drain_telemetry``)
and the holder closes, which saves the count caches. The server runs on
CUDA unless ``--device cpu`` (or ``platform = "cpu"``) is given, and
raises where there is no card. Port 0 binds a free port; the first line
on stdout names the address served. It logs through
``utils/logger.Logger`` on stderr (``--verbose`` adds its debug lines).

The server wires every plane from its config: the profiler and the
slow-query ring, the timeline, the roofline, the workload recorder, the
result and rank caches, the optimizer switch, the sentinel and its
objectives (``[slo]``), the failpoints (``[failpoints]`` or
``PILOSA_TPU_FAILPOINTS``, which also enable ``/internal/failpoints``),
the memory watchdog (whose gauge hook samples the sentinel), the
hybrid layout's re-layout pass, the runtime monitor
(``metric_poll_interval``, its gauges on ``/metrics``) and the
diagnostics reports (``diagnostics_url`` with ``diagnostics_interval``).
With ``cluster_peers`` (every node's
URI, this one's among them; the node's id is its URI) the server is one
node of a cluster of ``cluster_replicas`` replicas: the coordinator
fans queries out, imports go to every owner, the heartbeat marks dead
peers down and the translate replication loop pulls the primary's key
log; ``.topology`` in the data directory keeps the topology. With
``cluster_seeds`` (any members' URIs) the node joins an existing
cluster once its own listener answers, retrying every 5 s until a seed
takes it; its id is the holder's ``.id`` (a fresh one in memory), so a
restart on a new address rejoins as the same member. With
``anti_entropy_interval`` above 0 a cluster node reconciles its
replicas that often. With ``tls_certificate`` and ``tls_key`` it serves HTTPS, to
clients and peers alike. ``config`` prints the resolved settings as
JSON; ``generate-config`` prints the defaults as TOML.

The data tools: ``import`` loads CSV lines (``row,col``, or
``col,value`` with ``--field-type int``) into a local data directory
(``-d``, a ``Holder`` on ``--device``, default cuda) or through a running
server (``--host``, REMOTE_IMPORT_BATCH pairs a POST); ``check`` and
``inspect`` read fragment files with the port's codec (a torn tail is
reported, exit 1 from ``check``); ``backup`` tars a data directory
(skipping ``.torn`` sidecars and its own output) and ``restore`` unpacks
one (refusing a non-empty directory without ``--force``, paths that leave
it and members that are not files); ``fold`` rewrites fragment files as
snapshots with no op log (a torn tail only with ``--force``, saved to a
``.torn`` sidecar first), each through a temporary file and a rename.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import signal
import socket
import sys
import threading
import time
import uuid

import numpy as np


def drain_telemetry(api, watchdog=None) -> None:
    """The telemetry leg of the shutdown, once per API: stop the memory
    watchdog and dump its ring, then the slow-query ring, what the
    workload recorder saw as hot, the last request timelines, the
    roofline's calibration state, the sentinel's budgets and alerts,
    the process's kernel launches by kernel (``kernel launches:`` and
    a JSON object), and the finished spans; then stop an exporting
    tracer (its final flush)."""
    from pilosa_tpu_torch.ops import kernels
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
    api.logger.printf("kernel launches: %s",
                      json.dumps(dict(kernels.LAUNCHES)))
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
    """The exporting tracer of a configured endpoint, or None: the
    holder then makes a recording tracer, which the API adopts."""
    from pilosa_tpu_torch.utils.tracing import ExportingTracer
    if not cfg.tracing_endpoint:
        return None
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
    # [mesh] collectives can switch the mesh cohort launches off (one
    # way: never on past PILOSA_TPU_MESH=0).
    if not cfg.mesh_collectives:
        megamod.MESH_ENABLED = False


def build_mesh(cfg, device):
    """The server's mesh, as the JAX cli builds it: with ``mesh_devices``
    other than 1, the first ``mesh_devices`` visible devices of the
    server's type (0: all of them), when that is more than one or
    ``mesh_replicas`` is more than 1; else None."""
    import torch

    from pilosa_tpu_torch.parallel.mesh import MeshContext
    if cfg.mesh_devices == 1:
        return None
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    n = cfg.mesh_devices or len(devices)
    if n > 1 or cfg.mesh_replicas > 1:
        return MeshContext(devices[:n], replicas=cfg.mesh_replicas)
    return None


def init_distributed(cfg, device) -> None:
    """With ``jax_coordinator`` set and ``jax_num_processes`` above 1,
    join the torch.distributed process group there (the JAX cli's
    ``jax.distributed.initialize``): NCCL for a CUDA server, gloo for
    the CPU."""
    if cfg.jax_coordinator and cfg.jax_num_processes > 1:
        from pilosa_tpu_torch.parallel.multihost import init_process_group
        init_process_group(cfg.jax_coordinator, cfg.jax_num_processes,
                           cfg.jax_process_id, device.type)


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
    """The cluster of ``cfg.cluster_peers`` with this node among them, or
    of this node alone until it joins through ``cfg.cluster_seeds``, its
    ``.topology`` read back from the data directory (none in memory);
    None with neither. A static peer names a node by its URI, so that is
    the id there; a seed-joined node introduces itself by the holder's
    id (a fresh one for a holder in memory)."""
    from pilosa_tpu_torch.parallel.cluster import STATE_NORMAL, Cluster, \
        Node
    if not (cfg.cluster_peers or cfg.cluster_seeds):
        return None
    local_uri = cfg.advertise or f"{cfg.scheme}://{cfg.bind}"
    local_id = local_uri if cfg.cluster_peers \
        else holder.node_id or uuid.uuid4().hex
    cluster = Cluster(
        Node(local_id, local_uri,
             is_coordinator=bool(
                 cfg.cluster_peers
                 and local_uri == sorted(cfg.cluster_peers)[0])),
        replica_n=cfg.cluster_replicas,
        topology_path=(os.path.join(holder.path, ".topology")
                       if holder.path else None))
    for peer in cfg.cluster_peers:
        if peer != local_uri:
            cluster.add_node(Node(peer, peer))
    cluster.load()
    cluster.set_state(STATE_NORMAL)
    return cluster


class SeedJoin:
    """The seed join of ``cli server``, on a thread: wait until this
    node's own listener takes a connection (the seed's resize job calls
    back with ``/internal/resize/pull``), then ``join_via_seeds`` every
    5 s until a seed answers. ``stop`` ends the retries."""

    def __init__(self, api, cfg):
        self.api = api
        self.cfg = cfg
        self._stop = threading.Event()

    def start(self) -> None:
        threading.Thread(target=self._run, daemon=True,
                         name="seed-join").start()

    def _run(self) -> None:
        cfg, api = self.cfg, self.api
        # The bind address (loopback for a wildcard bind); a plain TCP
        # connect, so TLS certificates need not name it.
        host = cfg.host
        if host in ("", "0.0.0.0", "::", "localhost"):
            host = "127.0.0.1"
        while not self._stop.is_set():
            try:
                socket.create_connection((host, cfg.port),
                                         timeout=1.0).close()
                break
            except OSError:
                self._stop.wait(0.3)
        while not self._stop.is_set():
            try:
                api.join_via_seeds(cfg.cluster_seeds)
                api.logger.printf("seed join ok: cluster has %d node(s)",
                                  len(api.cluster.nodes()))
                return
            except Exception as e:
                api.logger.printf("seed join: %s; retrying in 5s", e)
                self._stop.wait(5.0)

    def stop(self) -> None:
        self._stop.set()


def start_cluster_loops(api, cfg):
    """The loops of a cluster node: the anti-entropy pass, the
    heartbeat and the translate replication loop (each off at an
    interval of 0), and the seed join with ``cluster_seeds``; returns
    them."""
    from pilosa_tpu_torch.parallel.heartbeat import Heartbeater, \
        TranslateReplicationLoop
    from pilosa_tpu_torch.parallel.syncer import AntiEntropyLoop
    loops = []
    if api.cluster is None:
        return loops
    if cfg.anti_entropy_interval > 0:
        ae = AntiEntropyLoop(api.syncer, cfg.anti_entropy_interval)
        ae.start()
        loops.append(ae)
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
    if cfg.cluster_seeds:
        sj = SeedJoin(api, cfg)
        sj.start()
        loops.append(sj)
    return loops


def build_server(cfg, holder):
    """The server of ``cfg`` over ``holder``: the API with its stats
    client, the holder's tracer and the cluster, its logger verbose as
    ``cfg``, every plane configured, the coalescer and the memory planes
    started, and the HTTP server bound (not yet serving), over TLS when
    configured.
    Returns (api, server, watchdog); ``stop_server`` undoes it."""
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    from pilosa_tpu_torch.server.http import make_server

    api = API(holder, stats=_stats(cfg),
              cluster=build_cluster(cfg, holder),
              client_ssl_context=cfg.client_ssl_context(),
              mesh=build_mesh(cfg, holder.device))
    api.logger.verbose = cfg.verbose
    configure_planes(api, cfg)
    if api.cluster_executor is not None:
        api.cluster_executor.configure(
            fanout_deadline_s=cfg.cluster_fanout_deadline_s,
            backoff_base_s=cfg.cluster_backoff_base_s,
            backoff_cap_s=cfg.cluster_backoff_cap_s,
            hedge_quantile=cfg.cluster_hedge_quantile)
        api._client.configure(
            timeout=cfg.cluster_rpc_timeout_s,
            health_timeout=cfg.cluster_health_timeout_s,
            resize_pull_timeout=cfg.cluster_resize_pull_timeout_s)
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
    """The shutdown: stop the cluster loops, the monitors and the
    broadcaster, drain the coalescer, stop the layout pass, write the
    telemetry to the log, close the listener."""
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


def start_monitors(api, cfg) -> list:
    """The diagnostics reports (started only with both
    ``diagnostics_url`` and ``diagnostics_interval``) and, unless the
    metrics are off or ``metric_poll_interval`` is 0, the runtime
    monitor; returns what ``stop_server`` stops."""
    from pilosa_tpu_torch.utils.diagnostics import DiagnosticsCollector, \
        RuntimeMonitor
    diagnostics = DiagnosticsCollector(
        url=cfg.diagnostics_url, interval=cfg.diagnostics_interval,
        holder=api.holder, logger=api.logger)
    diagnostics.start()
    out = [diagnostics]
    if cfg.metric_service != "none" and cfg.metric_poll_interval > 0:
        monitor = RuntimeMonitor(api.stats, cfg.metric_poll_interval,
                                 holder=api.holder)
        monitor.start()
        out.append(monitor)
    return out


def cmd_server(args) -> int:
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, {
        "data_dir": args.data_dir, "bind": args.bind,
        "verbose": args.verbose or None,
        "platform": args.platform,
        "coalescer_enabled": False if args.no_coalescer else None,
        "coalescer_window_ms": args.coalescer_window_ms,
    })
    logging.basicConfig(level=logging.DEBUG if cfg.verbose
                        else logging.INFO)
    holder = Holder(os.path.expanduser(cfg.data_dir) if cfg.data_dir
                    else None, device=args.device or cfg.device,
                    tracer=_tracer(cfg))
    init_distributed(cfg, holder.device)
    if holder.path is not None:
        holder.open()
    api, server, watchdog = build_server(cfg, holder)
    logger = api.logger
    loops = start_cluster_loops(api, cfg) + start_monitors(api, cfg)

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    addr = server.server_address
    coal = "off" if api.coalescer is None \
        else f"{cfg.coalescer_window_ms:g} ms"
    nodes = "" if api.cluster is None else \
        f" cluster={len(api.cluster.nodes())} nodes" \
        f" replicas={api.cluster.replica_n}"
    mesh = api.executor.mesh
    print(f"pilosa-tpu-torch server listening on "
          f"{cfg.scheme}://{addr[0]}:{addr[1]}"
          f" device={holder.device}"
          f" mesh={mesh.shape if mesh is not None else 'single-device'}"
          f" coalescer={coal}"
          f" data_dir={holder.path or '(memory)'}{nodes}", flush=True)
    logger.printf("pilosa-tpu server: data=%s bind=%s tls=%s mesh=%s "
                  "cluster=%s coalescer=%s", holder.path or "(memory)",
                  cfg.bind, "on" if cfg.tls_enabled else "off",
                  mesh.shape if mesh is not None else "single-device",
                  f"{len(api.cluster.nodes())} nodes" if api.cluster
                  else "no",
                  (f"window={cfg.coalescer_window_ms:g}ms "
                   f"batch<={cfg.coalescer_max_batch} "
                   f"queue<={cfg.coalescer_max_queue}")
                  if api.coalescer is not None else "off")
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


def _iter_import_csv(args, batch: int = 0):
    """(rows, cols, vals) batches of the CSV files: ``row,col`` lines,
    or ``col,value`` with ``--field-type int``. ``batch`` 0 gives one
    batch of everything (the local import); a positive ``batch`` streams
    batches of that many lines (the remote import)."""
    rows, cols, vals = [], [], []
    for path in args.files:
        with open(path, newline="") as f:
            for rec in csv.reader(f):
                if not rec:
                    continue
                if args.field_type == "int":
                    cols.append(int(rec[0]))
                    vals.append(int(rec[1]))
                else:
                    rows.append(int(rec[0]))
                    cols.append(int(rec[1]))
                if batch and len(cols) >= batch:
                    yield rows, cols, vals
                    rows, cols, vals = [], [], []
    if cols or not batch:
        yield rows, cols, vals


def _read_import_csv(args):
    """(rows, cols, vals) of every file at once (the local import)."""
    return next(_iter_import_csv(args))


# Pairs a POST of the remote import: a body of a few MB, one round trip
# a million pairs.
REMOTE_IMPORT_BATCH = 1_000_000


def _log_import_time(n: int, t0: float) -> None:
    """The import's own seconds on stderr, from after the process has
    started and loaded its modules, so that a caller can tell the import
    from the process start."""
    from pilosa_tpu_torch.utils.logger import Logger
    Logger().printf("import: %d records in %.3f s", n,
                    time.perf_counter() - t0)


def _import_remote(args) -> int:
    """POST the CSV's pairs in REMOTE_IMPORT_BATCH batches to a running
    server's import route, creating the index and field first when they
    are missing (an int field's range from a first pass over the
    values)."""
    from pilosa_tpu_torch.parallel.client import ClientError, \
        InternalClient

    t0 = time.perf_counter()

    ssl_ctx = None
    if args.tls_skip_verify:
        import ssl
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ssl_ctx.check_hostname = False
        ssl_ctx.verify_mode = ssl.CERT_NONE
    client = InternalClient(timeout=300.0, ssl_context=ssl_ctx)
    host = args.host.rstrip("/")

    def ensure(path: str, options: dict) -> None:
        try:
            client._req("POST", f"{host}{path}", obj={"options": options})
        except ClientError as e:
            if not InternalClient._is_already_exists(e):
                raise

    ensure(f"/index/{args.index}", {})
    if args.field_type == "int":
        lo = hi = None
        for _, _, vals in _iter_import_csv(args, REMOTE_IMPORT_BATCH):
            if vals:
                lo = min(vals) if lo is None else min(lo, min(vals))
                hi = max(vals) if hi is None else max(hi, max(vals))
        ensure(f"/index/{args.index}/field/{args.field}",
               {"type": "int", "min": lo or 0, "max": hi or 0})
    else:
        ensure(f"/index/{args.index}/field/{args.field}", {})
    url = f"{host}/index/{args.index}/field/{args.field}/import"
    total = 0
    for rows, cols, vals in _iter_import_csv(args, REMOTE_IMPORT_BATCH):
        if args.field_type == "int":
            body = {"columnIDs": cols, "values": vals}
        else:
            body = {"rowIDs": rows, "columnIDs": cols}
        client._req("POST", url, obj=body)
        total += len(cols)
    _log_import_time(total, t0)
    print(f"imported {total} records into "
          f"{args.index}/{args.field} via {host}")
    return 0


def cmd_import(args) -> int:
    """Bulk CSV import into a local data directory (``-d``) or through a
    running server (``--host``)."""
    if args.host:
        return _import_remote(args)
    if not args.data_dir:
        print("import: either --host or --data-dir is required",
              file=sys.stderr)
        return 2
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder

    t0 = time.perf_counter()
    holder = Holder(os.path.expanduser(args.data_dir), device=args.device)
    holder.open()
    idx = holder.create_index(args.index, error_if_exists=False)
    rows, cols, vals = _read_import_csv(args)
    if args.field_type == "int":
        lo, hi = (min(vals), max(vals)) if vals else (0, 0)
        f = idx.field(args.field) or idx.create_field(
            args.field, FieldOptions(type="int", min=lo, max=hi))
        f.import_values(np.array(cols, np.uint64), np.array(vals, np.int64))
    else:
        f = idx.field(args.field) or idx.create_field(args.field)
        f.import_bits(np.array(rows, np.uint64), np.array(cols, np.uint64))
    idx.add_existence(np.array(cols, np.uint64))
    holder.close()
    _log_import_time(len(cols), t0)
    print(f"imported {len(cols)} records into {args.index}/{args.field}")
    return 0


def cmd_check(args) -> int:
    """Read each fragment file with the port's codec: ``ok`` with its
    bits, containers and op count, or TORN TAIL / CORRUPT on stderr
    (exit 1 when any file is not ok)."""
    from pilosa_tpu_torch.storage.roaring import Bitmap

    bad = 0
    for path in args.files:
        try:
            with open(path, "rb") as f:
                b = Bitmap.from_bytes(f.read(), tolerate_torn_tail=True)
            if b.tail_dropped:
                bad += 1
                print(f"{path}: TORN TAIL: last op record truncated "
                      f"({b.tail_dropped} bytes; server open would "
                      f"sidecar+truncate)", file=sys.stderr)
            else:
                print(f"{path}: ok ({b.count()} bits, "
                      f"{len(b.containers)} containers, opN={b.op_n})")
        except Exception as e:
            bad += 1
            print(f"{path}: CORRUPT: {e}", file=sys.stderr)
    return 1 if bad else 0


def cmd_inspect(args) -> int:
    """Bits, containers, rows and op count of each fragment file; with
    ``--verbose`` each row's containers and bits."""
    from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
    from pilosa_tpu_torch.storage.roaring import Bitmap

    for path in args.files:
        with open(path, "rb") as f:
            b = Bitmap.from_bytes(f.read(), tolerate_torn_tail=True)
        rows = {}
        for key in sorted(b.containers):
            row = (key << 16) // SHARD_WIDTH
            rows.setdefault(row, [0, 0])
            rows[row][0] += 1
            rows[row][1] += b.container_count(key)
        print(f"{path}: {b.count()} bits, {len(b.containers)} containers, "
              f"{len(rows)} rows, opN={b.op_n}")
        if args.verbose:
            for row, (nc, nb) in sorted(rows.items()):
                print(f"  row {row}: {nc} containers, {nb} bits")
    return 0


class ParallelGzipWriter:
    """A write-only file that gzips what it is given in GZIP_BLOCK
    blocks, each an independent gzip member at level 9 (``tarfile``'s
    ``w:gz`` level), compressed on a pool of threads (zlib releases the
    GIL) and written in order: a multi-member gzip stream, which any
    gzip reader (``tarfile``'s ``r:*`` included) reads as one."""

    GZIP_BLOCK = 8 << 20

    def __init__(self, path: str):
        from concurrent.futures import ThreadPoolExecutor
        self._f = open(path, "wb")
        self._threads = min(8, os.cpu_count() or 1)
        self._pool = ThreadPoolExecutor(self._threads)
        self._pending = []
        self._buf = bytearray()

    @staticmethod
    def _member(block: bytes) -> bytes:
        import zlib
        c = zlib.compressobj(9, zlib.DEFLATED, 31)
        return c.compress(block) + c.flush()

    def _drain(self, keep: int) -> None:
        while len(self._pending) > keep:
            self._f.write(self._pending.pop(0).result())

    def write(self, data) -> int:
        self._buf += data
        while len(self._buf) >= self.GZIP_BLOCK:
            block = bytes(self._buf[:self.GZIP_BLOCK])
            del self._buf[:self.GZIP_BLOCK]
            self._pending.append(self._pool.submit(self._member, block))
            self._drain(2 * self._threads)
        return len(data)

    def close(self) -> None:
        try:
            if self._buf:
                self._pending.append(self._pool.submit(
                    self._member, bytes(self._buf)))
                self._buf = bytearray()
            self._drain(0)
        finally:
            self._pool.shutdown()
            self._f.close()


def cmd_backup(args) -> int:
    """Tar (gzip) every file of a data directory but ``.torn`` sidecars
    and the output itself. Consistent when no server writes the
    directory; a torn op-log tail caught mid-write is what a restore's
    open sidecars and cuts. The gzip stream is compressed on several
    threads (``ParallelGzipWriter``); it reads back as the JAX
    package's ``w:gz`` does."""
    import tarfile

    data_dir = os.path.expanduser(args.data_dir)
    if not os.path.isdir(data_dir):
        print(f"not a directory: {data_dir}", file=sys.stderr)
        return 1
    out_real = os.path.realpath(args.output)
    n = 0
    out = ParallelGzipWriter(args.output)
    try:
        with tarfile.open(fileobj=out, mode="w|") as tar:
            for root, _dirs, files in os.walk(data_dir):
                for name in files:
                    if name.endswith(".torn"):
                        continue
                    full = os.path.join(root, name)
                    if os.path.realpath(full) == out_real:
                        continue
                    tar.add(full, arcname=os.path.relpath(full, data_dir))
                    n += 1
    finally:
        out.close()
    print(f"backed up {n} files from {data_dir} to {args.output}")
    return 0


def cmd_restore(args) -> int:
    """Unpack a backup into a data directory, which must be empty unless
    ``--force`` (which replaces it). Members whose path leaves the
    directory, or that are neither files nor directories, refuse the
    whole archive before anything is written."""
    import shutil
    import tarfile

    data_dir = os.path.expanduser(args.data_dir)
    if os.path.isdir(data_dir) and os.listdir(data_dir):
        if not args.force:
            print(f"refusing to restore into non-empty {data_dir} "
                  f"(use --force)", file=sys.stderr)
            return 1
        shutil.rmtree(data_dir)
    os.makedirs(data_dir, exist_ok=True)
    with tarfile.open(args.input, "r:*") as tar:
        for m in tar.getmembers():
            dest = os.path.realpath(os.path.join(data_dir, m.name))
            if not dest.startswith(os.path.realpath(data_dir) + os.sep):
                print(f"unsafe path in archive: {m.name}", file=sys.stderr)
                return 1
            if not (m.isreg() or m.isdir()):
                print(f"unsafe member type in archive: {m.name}",
                      file=sys.stderr)
                return 1
        tar.extractall(data_dir, filter="data")
        n = len(tar.getmembers())
    print(f"restored {n} files into {data_dir}")
    return 0


def cmd_fold(args) -> int:
    """Rewrite each fragment file as a snapshot with no op log (its
    records replayed in), which readers of the plain roaring format
    open. A torn tail refuses the file unless ``--force``, which first
    appends the dropped bytes to ``FILE.torn``. The new bytes go to
    ``FILE.folding``, synced, then over the file by a rename."""
    from pilosa_tpu_torch.storage.roaring import Bitmap

    bad = 0
    for path in args.files:
        try:
            with open(path, "rb") as f:
                raw = f.read()
            b = Bitmap.from_bytes(raw, tolerate_torn_tail=True)
            if b.tail_dropped and not args.force:
                bad += 1
                print(f"{path}: torn op tail ({b.tail_dropped} bytes); "
                      "re-run with --force to fold anyway",
                      file=sys.stderr)
                continue
            if b.tail_dropped:
                side = path + ".torn"
                with open(side, "ab") as f:
                    f.write(raw[len(raw) - b.tail_dropped:])
                    f.flush()
                    os.fsync(f.fileno())
                print(f"{path}: sidecarred {b.tail_dropped} torn tail "
                      f"bytes to {side}", file=sys.stderr)
            out = b.write_bytes()
            tmp = path + ".folding"
            with open(tmp, "wb") as f:
                f.write(out)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            print(f"{path}: folded to pure snapshot "
                  f"({len(out)} bytes, {b.count()} bits)")
        except Exception as e:
            bad += 1
            print(f"{path}: FOLD FAILED: {e}", file=sys.stderr)
    return 1 if bad else 0


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
    sp.add_argument("--platform", default=None,
                    help="the config's platform: cuda, gpu or cpu (a "
                         "--device wins)")
    sp.add_argument("--no-coalescer", action="store_true",
                    help="serve every query on the direct path "
                         "(disable cross-request coalescing)")
    sp.add_argument("--coalescer-window-ms", type=float, default=None,
                    help="coalescer batching window in milliseconds")
    sp.set_defaults(fn=cmd_server)
    ip = sub.add_parser("import", help="bulk import CSV files")
    ip.add_argument("-d", "--data-dir", default=None,
                    help="local holder to import into (omit with --host)")
    ip.add_argument("--host", default=None,
                    help="import through a running server instead of a "
                         "local holder, e.g. http://localhost:10101")
    ip.add_argument("--tls-skip-verify", action="store_true",
                    help="with an https --host: skip certificate "
                         "verification")
    ip.add_argument("-i", "--index", required=True)
    ip.add_argument("-f", "--field", required=True)
    ip.add_argument("--field-type", default="set", choices=["set", "int"])
    ip.add_argument("--device", default=None,
                    help="torch device of the local holder (default cuda; "
                         "cpu to run without a card)")
    ip.add_argument("files", nargs="+")
    ip.set_defaults(fn=cmd_import)
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
    cp = sub.add_parser("check", help="check fragment file integrity")
    cp.add_argument("files", nargs="+")
    cp.set_defaults(fn=cmd_check)
    np_ = sub.add_parser("inspect", help="inspect fragment containers")
    np_.add_argument("files", nargs="+")
    np_.add_argument("--verbose", action="store_true")
    np_.set_defaults(fn=cmd_inspect)
    bp = sub.add_parser("backup", help="tar a data directory")
    bp.add_argument("-d", "--data-dir", required=True)
    bp.add_argument("-o", "--output", required=True)
    bp.set_defaults(fn=cmd_backup)
    rp = sub.add_parser("restore", help="unpack a backup tar")
    rp.add_argument("-d", "--data-dir", required=True)
    rp.add_argument("-i", "--input", required=True)
    rp.add_argument("--force", action="store_true")
    rp.set_defaults(fn=cmd_restore)
    gp = sub.add_parser("config", help="print resolved configuration")
    gp.add_argument("-c", "--config", default=None)
    gp.set_defaults(fn=cmd_config)
    fp = sub.add_parser(
        "fold", help="rewrite fragment files as pure snapshots "
        "(reference-readable: drops OP_ADD_ROARING extension records)")
    fp.add_argument("files", nargs="+")
    fp.add_argument("--force", action="store_true",
                    help="fold even files with a torn op tail")
    fp.set_defaults(fn=cmd_fold)
    gg = sub.add_parser("generate-config",
                        help="print default TOML config")
    gg.set_defaults(fn=cmd_generate_config)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
