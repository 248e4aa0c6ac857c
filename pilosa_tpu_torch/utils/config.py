"""Server configuration, after the JAX package's ``utils/config.py``.

Precedence: command-line flags > ``PILOSA_TPU_*`` environment > the TOML
file (``server -c``) > defaults. Every key the port serves has the JAX
package's name, default and validation. A TOML table ``[name] key = v``
is the flat key ``name_key``; ``[failpoints]`` and ``[slo]`` stay tables
(their keys carry dots and slashes).

Every key of the JAX package's ``Config`` is taken, with one
difference: ``data_dir`` defaults to ``""``, so the server keeps its
holder in memory unless a directory is given. ``platform`` (also
``PILOSA_TPU_PLATFORM`` and ``cli server --platform``) names the
server's device the way the JAX package names its platform: ``""`` the
default (``cuda``), ``cpu`` the CPU, ``gpu`` or ``cuda`` the card; any
other value is refused (``Config.device``). ``metric_poll_interval`` is
the runtime monitor's period, ``diagnostics_interval`` and
``diagnostics_url`` the diagnostics reports' (``utils/diagnostics.py``).

The mesh's keys (``mesh_devices``, 0 meaning every visible CUDA
device; ``mesh_replicas``; ``mesh_collectives``, which can switch the
mesh cohort path off but never on past ``PILOSA_TPU_MESH=0``; a
``[mesh]`` table or the flat spelling) and the multi-process keys
(``jax_coordinator``, ``jax_num_processes``, ``jax_process_id``, which
``cli server`` hands to ``torch.distributed`` as the JAX package hands
them to ``jax.distributed``) are the JAX package's.

The cluster's keys (``cluster_peers``, ``cluster_replicas``,
``cluster_seeds``, the fan-out, RPC and resize-pull timeouts, backoff
and hedging, ``advertise``, the anti-entropy, heartbeat and translate
replication intervals) and TLS
(``tls_certificate``, ``tls_key``, ``tls_ca_certificate``,
``tls_skip_verify``; ``server_ssl_context``/``client_ssl_context``) are
the JAX package's. A list key from the environment is comma-separated.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, Optional

ENV_PREFIX = "PILOSA_TPU_"


@dataclass
class Config:
    """Resolved server settings; the fields are the JAX package's, in
    its order."""
    data_dir: str = ""
    bind: str = "localhost:10101"
    verbose: bool = False
    # Queries with more write calls than this fail; 0 is no limit.
    max_writes_per_request: int = 5000
    # Queries slower than this (seconds) go to the log and the
    # slow-query ring (GET /debug/queries); 0 disables both.
    long_query_time: float = 0.0
    # [profile]: fence 1 in N unforced queries for device time (0: only
    # ?profile=true fences); the /debug/queries ring's bound.
    profile_sample_every: int = 0
    profile_slow_ring: int = 128
    # [coalescer]: concurrent single-query requests share one batch.
    coalescer_enabled: bool = True
    coalescer_window_ms: float = 1.5
    coalescer_max_batch: int = 64
    coalescer_max_queue: int = 256
    coalescer_deadline_ms: float = 0.0
    coalescer_pipeline: bool = True
    # [mesh]: the device mesh of `cli server` (0 = every visible CUDA
    # device; a mesh is built when that is more than one), its replica
    # axis, and the mesh cohort path's switch.
    mesh_devices: int = 0
    mesh_replicas: int = 1
    mesh_collectives: bool = True
    # The server's device, named as the JAX package names its platform:
    # "" (the default, cuda), "cpu", "gpu" or "cuda".
    platform: str = ""
    # Multi-process startup: with more than one process the server joins
    # a torch.distributed process group at tcp://<coordinator> (NCCL on
    # the card, gloo on the CPU) before it builds its mesh.
    jax_coordinator: str = ""
    jax_num_processes: int = 0
    jax_process_id: int = -1
    # The anti-entropy pass's period (seconds; 0 or less: off).
    anti_entropy_interval: float = 600.0
    # [heartbeat]: the failure detector probes this often (0: off),
    # marks a peer down after `suspect` failed probes in a row and
    # probes at most `probes` healthy peers a round.
    heartbeat_interval: float = 5.0
    heartbeat_suspect: int = 3
    heartbeat_probes: int = 2
    # Standing translate-log replication from the primary (0: off).
    translate_replication_interval: float = 10.0
    # [telemetry]: the memory watchdog's period (0 disables it), its
    # ring, and the pressure watermark as a share of the bank budget.
    telemetry_sample_every_s: float = 10.0
    telemetry_ring: int = 360
    telemetry_hbm_watermark: float = 0.9
    # [workload]: the workload recorder (utils/hotspots.py).
    workload_enabled: bool = True
    workload_half_life_s: float = 600.0
    workload_window_s: float = 300.0
    workload_top_k: int = 10
    workload_max_fragments: int = 4096
    workload_max_rows: int = 4096
    workload_max_signatures: int = 1024
    # [cache]: the result cache (executor/result_cache.py; host bytes)
    # and the device rank cache (core/cache.py). PILOSA_TPU_RESULT_CACHE=0
    # and PILOSA_TPU_RANK_CACHE=0 win over these.
    cache_result_enabled: bool = True
    cache_result_max_bytes: int = 256 << 20
    cache_rank_enabled: bool = True
    cache_rank_max_entries: int = 64
    # [optimizer]: the plan optimizer (ops/plan_opt.py); can only turn
    # it off.
    optimizer_enabled: bool = True
    # [layout]: the hybrid layout's re-layout pass (core/layout.py).
    layout_enabled: bool = True
    layout_interval_s: float = 30.0
    layout_demote_density: float = 0.25
    layout_min_bytes: int = 1 << 20
    layout_promote_rate: float = 0.5
    # [timeline]: request timelines and the dispatch-gap analyzer.
    timeline_enabled: bool = True
    timeline_ring: int = 256
    timeline_sample_every: int = 1
    timeline_gap_window_s: float = 60.0
    # [roofline]: the roofline recorder (gbps 0: the card's own figure).
    roofline_enabled: bool = True
    roofline_gbps: float = 0.0
    roofline_ewma_alpha: float = 0.25
    roofline_max_cohorts: int = 256
    # Metrics: mem | statsd | none, and the statsd agent's address.
    metric_service: str = "mem"
    metric_host: str = "localhost:8125"
    # The runtime monitor's period (seconds; 0: off).
    metric_poll_interval: float = 10.0
    # Diagnostics reports: off unless both are set.
    diagnostics_interval: float = 0.0
    diagnostics_url: str = ""
    # Tracing: an OTLP/HTTP JSON endpoint ("" records spans in memory)
    # and the head sampler.
    tracing_endpoint: str = ""
    tracing_service_name: str = "pilosa-tpu"
    tracing_sampler_type: str = "const"
    tracing_sampler_param: float = 1.0
    # [cluster]: the static peer URIs (this node's own among them), the
    # replica count and the seeds a node joins through at boot (any one
    # member that answers; a member that restarts rejoins); the
    # fan-out's deadline budget, the internal client's RPC,
    # health-probe and resize-pull timeouts, the failover backoff and
    # the hedged-read quantile (0: off).
    cluster_peers: list = field(default_factory=list)
    cluster_replicas: int = 1
    cluster_seeds: list = field(default_factory=list)
    cluster_fanout_deadline_s: float = 30.0
    cluster_rpc_timeout_s: float = 30.0
    cluster_health_timeout_s: float = 5.0
    cluster_resize_pull_timeout_s: float = 600.0
    cluster_backoff_base_s: float = 0.05
    cluster_backoff_cap_s: float = 2.0
    cluster_hedge_quantile: float = 0.0
    # [failpoints]: site -> spec (utils/failpoints.py); any entry arms
    # it and enables POST /internal/failpoints.
    failpoints: dict = field(default_factory=dict)
    # [slo]: endpoint -> objective (utils/sentinel.py), for example
    # query = "99.9% < 25ms".
    slo: dict = field(default_factory=dict)
    # [sentinel]: history rings and the alert ring (utils/sentinel.py).
    sentinel_enabled: bool = True
    sentinel_ring: int = 720
    sentinel_decimate: int = 10
    sentinel_alert_ring: int = 256
    # The URI peers reach this node at (default <scheme>://<bind>).
    advertise: str = ""
    # [tls]: with certificate and key the listener serves HTTPS, to
    # clients and nodes alike, and peers are dialed over https;
    # ca_certificate verifies peers against a private CA, skip_verify
    # verifies nothing.
    tls_certificate: str = ""
    tls_key: str = ""
    tls_ca_certificate: str = ""
    tls_skip_verify: bool = False

    @property
    def tls_enabled(self) -> bool:
        return bool(self.tls_certificate or self.tls_key)

    @property
    def scheme(self) -> str:
        return "https" if self.tls_enabled else "http"

    @property
    def host(self) -> str:
        return self.bind.rsplit(":", 1)[0] or "localhost"

    @property
    def port(self) -> int:
        parts = self.bind.rsplit(":", 1)
        return int(parts[1]) if len(parts) == 2 and parts[1] else 10101

    @property
    def device(self) -> Optional[str]:
        """The torch device ``platform`` names: "cpu", "cuda", or None
        for the default (cuda)."""
        return {"": None, "cpu": "cpu", "gpu": "cuda",
                "cuda": "cuda"}[self.platform]

    def validate(self) -> None:
        """The JAX package's checks of its keys (a port of 0 binds a
        free port), and the platforms the port serves."""
        if self.port < 0 or self.port > 65535:
            raise ValueError(f"invalid port {self.port}")
        if self.platform not in ("", "cpu", "gpu", "cuda"):
            raise ValueError(
                f"platform {self.platform!r} is not served by "
                f"pilosa_tpu_torch (\"\", cpu, gpu or cuda)")
        if self.mesh_replicas < 1:
            raise ValueError("mesh_replicas must be >= 1")
        if bool(self.tls_certificate) != bool(self.tls_key):
            raise ValueError(
                "tls_certificate and tls_key must be set together")
        if self.coalescer_window_ms < 0 or self.coalescer_deadline_ms < 0:
            raise ValueError("coalescer window/deadline must be >= 0")
        if self.coalescer_max_batch < 1 or self.coalescer_max_queue < 1:
            raise ValueError("coalescer max_batch/max_queue must be >= 1")
        if self.profile_sample_every < 0:
            raise ValueError("profile sample_every must be >= 0")
        if self.profile_slow_ring < 1:
            raise ValueError("profile slow_ring must be >= 1")
        if self.telemetry_sample_every_s < 0:
            raise ValueError("telemetry sample_every_s must be >= 0")
        if self.workload_half_life_s <= 0 or self.workload_window_s <= 0:
            raise ValueError(
                "workload half_life_s/window_s must be > 0")
        if self.workload_top_k < 1 or self.workload_max_fragments < 1 \
                or self.workload_max_rows < 1 \
                or self.workload_max_signatures < 1:
            raise ValueError(
                "workload top_k/max_* bounds must be >= 1")
        if self.telemetry_ring < 1:
            raise ValueError("telemetry ring must be >= 1")
        if self.cache_result_max_bytes < 0:
            raise ValueError("cache result_max_bytes must be >= 0")
        if self.cache_rank_max_entries < 1:
            raise ValueError("cache rank_max_entries must be >= 1")
        if self.layout_interval_s < 0:
            raise ValueError("layout interval_s must be >= 0")
        if not 0 <= self.layout_demote_density <= 1:
            raise ValueError(
                "layout demote_density must be in [0, 1]")
        if self.layout_min_bytes < 0:
            raise ValueError("layout min_bytes must be >= 0")
        if self.layout_promote_rate < 0:
            raise ValueError("layout promote_rate must be >= 0")
        if self.timeline_ring < 1 or self.timeline_sample_every < 1:
            raise ValueError(
                "timeline ring/sample_every must be >= 1")
        if self.timeline_gap_window_s <= 0:
            raise ValueError("timeline gap_window_s must be > 0")
        if self.roofline_gbps < 0:
            raise ValueError("roofline gbps must be >= 0 (0 = auto)")
        if not 0 < self.roofline_ewma_alpha <= 1:
            raise ValueError("roofline ewma_alpha must be in (0, 1]")
        if self.roofline_max_cohorts < 1:
            raise ValueError("roofline max_cohorts must be >= 1")
        if not 0 <= self.telemetry_hbm_watermark <= 1:
            raise ValueError(
                "telemetry hbm_watermark must be in [0, 1]")
        if self.cluster_fanout_deadline_s < 0:
            raise ValueError("cluster fanout_deadline_s must be >= 0")
        if self.cluster_rpc_timeout_s <= 0 \
                or self.cluster_health_timeout_s <= 0 \
                or self.cluster_resize_pull_timeout_s <= 0:
            raise ValueError(
                "cluster rpc/health/resize_pull timeouts must be > 0")
        if self.cluster_backoff_base_s < 0 \
                or self.cluster_backoff_cap_s < 0:
            raise ValueError("cluster backoff base/cap must be >= 0")
        if not 0 <= self.cluster_hedge_quantile < 1:
            raise ValueError(
                "cluster hedge_quantile must be in [0, 1)")
        if self.failpoints:
            from pilosa_tpu_torch.utils.failpoints import parse_spec
            for site, spec in self.failpoints.items():
                parse_spec(str(spec))
                if not isinstance(site, str) or not site:
                    raise ValueError(
                        f"failpoint site names must be strings: "
                        f"{site!r}")
        if self.slo:
            from pilosa_tpu_torch.utils.sentinel import parse_objective
            for ep, spec in self.slo.items():
                if not isinstance(ep, str) or not ep:
                    raise ValueError(
                        f"slo endpoint keys must be strings: {ep!r}")
                parse_objective(str(spec))
        if self.sentinel_ring < 2:
            raise ValueError("sentinel ring must be >= 2")
        if self.sentinel_decimate < 1:
            raise ValueError("sentinel decimate must be >= 1")
        if self.sentinel_alert_ring < 8:
            raise ValueError("sentinel alert_ring must be >= 8")

    def server_ssl_context(self) -> Any:
        """The listener's ``ssl.SSLContext``, or None when TLS is off."""
        if not self.tls_enabled:
            return None
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(os.path.expanduser(self.tls_certificate),
                            os.path.expanduser(self.tls_key))
        return ctx

    def client_ssl_context(self) -> Any:
        """The ``ssl.SSLContext`` that dials https peers, or None on a
        plain http cluster: the CA bundle's, the system's, or one that
        verifies nothing (``tls_skip_verify``)."""
        if not (self.tls_enabled or self.tls_ca_certificate
                or self.tls_skip_verify):
            return None
        import ssl
        if self.tls_skip_verify:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            return ctx
        ctx = ssl.create_default_context()
        if self.tls_ca_certificate:
            ctx.load_verify_locations(
                os.path.expanduser(self.tls_ca_certificate))
        return ctx

    def to_toml(self) -> str:
        """The ``generate-config`` text: one ``key = value`` line a flat
        key, then the non-empty tables."""
        lines = []
        tables = []
        for k, v in asdict(self).items():
            if isinstance(v, str):
                lines.append(f'{k} = "{v}"')
            elif isinstance(v, bool):
                lines.append(f"{k} = {str(v).lower()}")
            elif isinstance(v, list):
                items = ", ".join(f'"{x}"' for x in v)
                lines.append(f"{k} = [{items}]")
            elif isinstance(v, dict):
                if v:
                    tables.append((k, v))
            else:
                lines.append(f"{k} = {v}")
        out = "\n".join(lines) + "\n"
        for name, tbl in tables:
            out += f"\n[{name}]\n"
            for sk, sv in tbl.items():
                out += f'"{sk}" = "{sv}"\n'
        return out


def _parse_env(cur: Any, env: str, key: str) -> Any:
    if isinstance(cur, bool):
        return env.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(env)
    if isinstance(cur, float):
        return float(env)
    if isinstance(cur, list):
        return [part for part in env.split(",") if part]
    if isinstance(cur, dict):
        # PILOSA_TPU_FAILPOINTS="site=spec;site=spec": entries merge over
        # (and win against) the TOML table.
        merged = dict(cur)
        for part in env.split(";"):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad {ENV_PREFIX}{key.upper()} entry "
                                 f"{part!r} (want site=spec)")
            name, spec = part.split("=", 1)
            merged[name.strip()] = spec.strip()
        return merged
    return env


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None,
                environ: Optional[Dict[str, str]] = None) -> Config:
    """flags (``overrides``, None values skipped) > environment
    (``environ``, default ``os.environ``) > the TOML file at ``path`` >
    defaults. An unknown key fails as in the JAX package."""
    env_map = os.environ if environ is None else environ
    cfg = Config()
    settable = {f.name for f in fields(cfg)}
    if path:
        with open(path, "rb") as f:
            data = tomllib.load(f)
        for k, v in data.items():
            k = k.replace("-", "_")
            if k in ("failpoints", "slo"):
                if not isinstance(v, dict):
                    raise ValueError(
                        f"[{k}] must be a table of "
                        f"key = \"value\" entries")
                setattr(cfg, k, {str(sk): str(sv)
                                 for sk, sv in v.items()})
                continue
            if isinstance(v, dict):
                for sk, sv in v.items():
                    flat = f"{k}_{sk.replace('-', '_')}"
                    if flat not in settable:
                        raise ValueError(
                            f"unknown config key {k}.{sk!r}")
                    setattr(cfg, flat, sv)
            elif k in settable:
                setattr(cfg, k, v)
            else:
                raise ValueError(f"unknown config key {k!r}")
    for k in settable:
        env = env_map.get(ENV_PREFIX + k.upper())
        if env is not None:
            setattr(cfg, k, _parse_env(getattr(cfg, k), env, k))
    for k, v in (overrides or {}).items():
        if v is None:
            continue
        if k not in settable:
            raise ValueError(f"unknown config key {k!r}")
        setattr(cfg, k, v)
    cfg.validate()
    return cfg
