"""The port's server configuration (``utils/config.py``, ``cli config``,
``cli generate-config``, ``cli server -c``) against the JAX package's, on
the CPU: the same TOML files and environments resolve every shared key to
the same value, ``generate-config`` prints the JAX package's text but for
``data_dir`` (whose default is the in-memory holder), every key the port
once refused as not ported (the platform, the runtime monitor's and the
diagnostics' keys among them) loads as the JAX package loads it, the
cluster's keys (the seed join's, the resize pull's and the anti-entropy
interval among them) and TLS keys resolve from every source as the JAX
package's, and the server started from a TOML file wires its planes from
it."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from pilosa_tpu.utils import config as jcfg

from pilosa_tpu_torch.utils import config as pcfg


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag this
    file's sampled fences raise must not reach a later test's sentinel
    (its ``roofline.drift`` alert)."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOMLS = {
    "empty": "",
    "flat": ('bind = "127.0.0.1:9999"\nverbose = true\n'
             "long_query_time = 0.25\nmax_writes_per_request = 7\n"
             'metric_service = "none"\n'),
    "tables": ("[profile]\nsample_every = 4\nslow_ring = 16\n"
               "[coalescer]\nwindow_ms = 2.5\nmax_batch = 8\n"
               "pipeline = false\n"
               "[telemetry]\nsample_every_s = 0.5\nring = 30\n"
               "hbm_watermark = 0.8\n"
               "[workload]\nenabled = true\nhalf_life_s = 60.0\n"
               "window_s = 30.0\ntop_k = 5\nmax_signatures = 64\n"
               "[cache]\nresult_enabled = true\n"
               "result_max_bytes = 1048576\nrank_enabled = false\n"
               "rank_max_entries = 4\n"
               "[optimizer]\nenabled = false\n"
               "[layout]\nenabled = true\ninterval_s = 5.0\n"
               "demote_density = 0.5\nmin_bytes = 4096\n"
               "promote_rate = 1.5\n"
               "[timeline]\nring = 64\nsample_every = 2\n"
               "gap_window_s = 10.0\n"
               "[roofline]\nenabled = false\ngbps = 3350.0\n"
               "ewma_alpha = 0.5\nmax_cohorts = 32\n"
               "[sentinel]\nring = 100\ndecimate = 4\n"
               "alert_ring = 16\n"),
    "dict_tables": ('[slo]\nquery = "99% < 25ms"\n'
                    '"/batch/query" = "99.9% < 100ms"\n'
                    '[failpoints]\n"api.query" = "errorx2"\n'),
    "tracing": ('tracing_endpoint = "http://localhost:4318/v1/traces"\n'
                'tracing_sampler_type = "probabilistic"\n'
                "tracing_sampler_param = 0.5\n"),
}

ENVS = {
    "none": {},
    "overrides": {"PILOSA_TPU_PROFILE_SAMPLE_EVERY": "3",
                  "PILOSA_TPU_WORKLOAD_ENABLED": "false",
                  "PILOSA_TPU_CACHE_RESULT_MAX_BYTES": "4096",
                  "PILOSA_TPU_SENTINEL_DECIMATE": "2",
                  "PILOSA_TPU_SLO": "query=99.9% < 5ms;metrics=99% < 1s",
                  "PILOSA_TPU_FAILPOINTS": "api.status=delay(0)"},
}


def _shared(cfg):
    """The resolved values of the keys the port has (data_dir aside)."""
    d = dataclasses.asdict(cfg)
    d.pop("data_dir")
    return {k: d[k] for k in
            (f.name for f in dataclasses.fields(pcfg.Config))
            if k != "data_dir"}


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("PILOSA_TPU_"):
            monkeypatch.delenv(k)
    return monkeypatch


@pytest.mark.parametrize("env", sorted(ENVS))
@pytest.mark.parametrize("toml", sorted(TOMLS))
def test_same_toml_and_env_resolve_alike(tmp_path, clean_env, toml, env):
    path = tmp_path / "c.toml"
    path.write_text(TOMLS[toml])
    for k, v in ENVS[env].items():
        clean_env.setenv(k, v)
    want = jcfg.load_config(str(path))
    got = pcfg.load_config(str(path))
    assert _shared(got) == _shared(want)


def test_flags_win_over_env_and_file(tmp_path, clean_env):
    path = tmp_path / "c.toml"
    path.write_text("[coalescer]\nwindow_ms = 2.5\n")
    clean_env.setenv("PILOSA_TPU_COALESCER_WINDOW_MS", "3.5")
    flags = {"coalescer_window_ms": 4.5, "bind": "127.0.0.1:1234",
             "verbose": None}
    got = pcfg.load_config(str(path), dict(flags))
    want = jcfg.load_config(str(path), dict(flags))
    assert _shared(got) == _shared(want)
    assert got.coalescer_window_ms == 4.5 and got.port == 1234


def test_every_shared_key_has_the_jax_default():
    got = dataclasses.asdict(pcfg.Config())
    want = dataclasses.asdict(jcfg.Config())
    for k, v in got.items():
        if k != "data_dir":
            assert v == want[k], k
    # The port's keys are the JAX package's, all of them.
    assert set(got) == set(want)
    assert not hasattr(pcfg, "NOT_PORTED")
    assert got["data_dir"] == ""


def test_generate_config_matches_jax_but_refused_keys():
    def lines(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("data_dir = ")]
    got = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "generate-config"],
        cwd=REPO, capture_output=True, text=True, check=True).stdout
    want = jcfg.Config().to_toml()
    assert lines(got) == lines(want)
    assert 'data_dir = ""' in got.splitlines()
    # The text loads back to the defaults.
    import tomllib
    assert pcfg.load_config(environ={}) == pcfg.Config()
    assert set(tomllib.loads(got)) == {
        f.name for f in dataclasses.fields(pcfg.Config)} - {"failpoints",
                                                             "slo"}


# The keys of seed join, resize and anti-entropy: refused until the port
# had the dynamic cluster, taken as the JAX package takes them since.
DYNAMIC_CLUSTER_KEYS = ("anti_entropy_interval", "cluster_resize_pull_timeout_s",
                        "cluster_seeds")
# The mesh's and the multi-process startup's keys: refused until the
# port had the mesh, taken as the JAX package takes them since.
MESH_KEYS = ("jax_coordinator", "jax_num_processes", "jax_process_id",
             "mesh_collectives", "mesh_devices", "mesh_replicas")


# The platform, runtime monitor and diagnostics keys: refused until the
# port had the diagnostics plane, taken as the JAX package takes them
# since (from the file, the environment and a flag).
MONITOR_KEYS = ("diagnostics_interval", "diagnostics_url",
                "metric_poll_interval", "platform")


@pytest.mark.parametrize("key", list(MONITOR_KEYS)
                         + sorted(DYNAMIC_CLUSTER_KEYS) + list(MESH_KEYS))
def test_refused_key_fails_with_its_message(tmp_path, clean_env, key):
    """Every key the port once refused as not ported loads from a file
    as the JAX package loads it; the platform, monitor and diagnostics
    keys also from the environment and a flag, with a value that is not
    their default."""
    value = dataclasses.asdict(jcfg.Config())[key]
    text = json.dumps(value) if not isinstance(value, bool) \
        else str(value).lower()
    if isinstance(value, list):
        text = json.dumps(["http://localhost:10101"])
    path = tmp_path / "c.toml"
    path.write_text(f"{key} = {text}\n")
    want = jcfg.load_config(str(path))
    got = pcfg.load_config(str(path), environ={})
    assert getattr(got, key) == getattr(want, key)
    assert _shared(got) == _shared(want)
    if key not in MONITOR_KEYS:
        return
    other = {"diagnostics_interval": 2.5, "metric_poll_interval": 0.5,
             "diagnostics_url": "http://127.0.0.1:1/d",
             "platform": "cpu"}[key]
    clean_env.setenv("PILOSA_TPU_" + key.upper(), str(other))
    got, want = pcfg.load_config(), jcfg.load_config()
    assert getattr(got, key) == getattr(want, key) == other
    assert _shared(got) == _shared(want)
    clean_env.delenv("PILOSA_TPU_" + key.upper())
    got = pcfg.load_config(overrides={key: other}, environ={})
    want = jcfg.load_config(overrides={key: other})
    assert getattr(got, key) == getattr(want, key) == other


# The static cluster's and TLS keys, each with a value that is not its
# default (and, for the TLS pair, the key that must come with it).
CLUSTER_KEYS = {
    "cluster_peers": (["http://a:1", "http://b:2"], None),
    "cluster_replicas": (3, None),
    "cluster_seeds": (["http://a:1"], None),
    "cluster_resize_pull_timeout_s": (45.0, None),
    "anti_entropy_interval": (1.5, None),
    "cluster_fanout_deadline_s": (12.5, None),
    "cluster_rpc_timeout_s": (7.0, None),
    "cluster_health_timeout_s": (2.5, None),
    "cluster_backoff_base_s": (0.2, None),
    "cluster_backoff_cap_s": (4.0, None),
    "cluster_hedge_quantile": (0.9, None),
    "advertise": ("http://node0:10101", None),
    "heartbeat_interval": (0.5, None),
    "heartbeat_suspect": (5, None),
    "heartbeat_probes": (4, None),
    "translate_replication_interval": (2.5, None),
    "tls_certificate": ("c.pem", ("tls_key", "k.pem")),
    "tls_key": ("k.pem", ("tls_certificate", "c.pem")),
    "tls_ca_certificate": ("ca.pem", None),
    "tls_skip_verify": (True, None),
}


def _toml_value(v):
    return str(v).lower() if isinstance(v, bool) else json.dumps(v)


def _env_value(v):
    return ",".join(v) if isinstance(v, list) else str(v).lower() \
        if isinstance(v, bool) else str(v)


@pytest.mark.parametrize("key", sorted(CLUSTER_KEYS))
def test_ported_cluster_keys_match_jax(tmp_path, clean_env, key):
    """Each key of the static cluster and TLS, set in the TOML file (flat
    and as its table), in the environment and as a flag, resolves as
    the JAX package's ``Config`` does."""
    value, pair = CLUSTER_KEYS[key]
    sets = {key: value}
    if pair is not None:
        sets[pair[0]] = pair[1]
    texts = ["".join(f"{k} = {_toml_value(v)}\n" for k, v in sets.items())]
    table, _, rest = key.partition("_")
    if table in ("cluster", "heartbeat", "tls") and pair is None:
        texts.append(f"[{table}]\n{rest} = {_toml_value(value)}\n")
    for i, text in enumerate(texts):
        path = tmp_path / f"c{i}.toml"
        path.write_text(text)
        got, want = pcfg.load_config(str(path)), jcfg.load_config(str(path))
        assert getattr(got, key) == getattr(want, key) == value, text
        assert _shared(got) == _shared(want)
    for k, v in sets.items():
        clean_env.setenv("PILOSA_TPU_" + k.upper(), _env_value(v))
    got, want = pcfg.load_config(), jcfg.load_config()
    assert getattr(got, key) == getattr(want, key) == value
    assert _shared(got) == _shared(want)
    for k in sets:
        clean_env.delenv("PILOSA_TPU_" + k.upper())
    got = pcfg.load_config(overrides=dict(sets), environ={})
    want = jcfg.load_config(overrides=dict(sets))
    assert getattr(got, key) == getattr(want, key) == value
    assert _shared(got) == _shared(want)
    assert (got.scheme, got.tls_enabled) == (want.scheme, want.tls_enabled)


@pytest.mark.parametrize("table,key", [("anti_entropy", "interval"),
                                       ("cluster", "seeds"),
                                       ("mesh", "devices"),
                                       ("diagnostics", "interval")])
def test_refused_table_key_names_its_table(tmp_path, table, key):
    """A once-refused key set in its table (the dynamic cluster's, the
    mesh's, the diagnostics') resolves as the JAX package resolves it."""
    path = tmp_path / "c.toml"
    flat = f"{table}_{key}"
    value = {"cluster_seeds": '["http://a:1"]',
             "mesh_devices": "2"}.get(flat, "2.5")
    path.write_text(f"[{table}]\n{key} = {value}\n")
    got = pcfg.load_config(str(path), environ={})
    want = jcfg.load_config(str(path))
    assert getattr(got, flat) == getattr(want, flat) == json.loads(value)


@pytest.mark.parametrize("text,match", [
    ("nope = 1\n", "unknown config key"),
    ("[profile]\nnope = 1\n", "unknown config key"),
    ("[slo]\nquery = \"fast\"\n", "objective"),
    ("[failpoints]\n\"api.query\" = \"explode\"\n", "failpoint spec"),
    ("[coalescer]\nmax_batch = 0\n", "max_batch"),
    ("[roofline]\newma_alpha = 2.0\n", "ewma_alpha"),
    ("[sentinel]\nalert_ring = 2\n", "alert_ring"),
])
def test_validation_matches_jax(tmp_path, text, match):
    path = tmp_path / "c.toml"
    path.write_text(text)
    for mod in (jcfg, pcfg):
        with pytest.raises(ValueError, match=match):
            mod.load_config(str(path), environ={}) if mod is pcfg \
                else mod.load_config(str(path))


def test_cli_config_prints_the_resolved_settings(tmp_path):
    path = tmp_path / "c.toml"
    path.write_text(TOMLS["tables"] + TOMLS["dict_tables"])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_TPU_")}
    out = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "config", "-c",
         str(path)], cwd=REPO, capture_output=True, text=True, check=True,
        env=env).stdout
    got = json.loads(out)
    want = dataclasses.asdict(jcfg.load_config(str(path)))
    assert {k: v for k, v in got.items() if k != "data_dir"} == \
        {k: want[k] for k in got if k != "data_dir"}


def test_server_takes_its_planes_from_the_toml(tmp_path):
    """``cli server -c`` on the CPU: the sentinel's objectives, the
    workload recorder, the result cache and the failpoints come from the
    file; a refused key stops the server before it listens, and the
    anti-entropy interval, which the JAX package takes, no longer does."""
    import queue
    import threading
    import urllib.request
    path = tmp_path / "c.toml"
    path.write_text('bind = "127.0.0.1:0"\nanti_entropy_interval = 5.0\n'
                    '[slo]\nquery = "99% < 25ms"\n'
                    "[cache]\nresult_max_bytes = 4096\n"
                    "[workload]\ntop_k = 3\n"
                    "[sentinel]\nring = 50\n"
                    "[telemetry]\nsample_every_s = 0.2\n"
                    '[failpoints]\n"api.status" = "delay(0)"\n')
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_TPU_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-c",
         str(path), "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        first = lines.get(timeout=120)
        base = first.split("listening on ")[1].split()[0]

        def get(p):
            return json.loads(urllib.request.urlopen(base + p,
                                                     timeout=30).read())

        assert get("/debug/slo")["objectives"]["query"]["thresholdS"] \
            == 0.025
        assert get("/debug/hotspots")["resultCache"]["maxBytes"] == 4096
        assert get("/internal/failpoints")["sites"]["api.status"][
            "armed"] == "delay(0)"
        # The watchdog samples the sentinel at the file's period.
        deadline = time.time() + 60
        while get("/internal/health")["watchdog"]["samples"] < 2:
            assert time.time() < deadline
            time.sleep(0.05)
        assert get("/debug/history")["samples"] >= 1
        health = get("/internal/health")
        assert health["watchdog"]["running"]
        for k in ("resultCache", "workload", "slo", "layout", "timeline"):
            assert k in health
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    err = proc.stderr.read()
    assert "sentinel:" in err and "workload:" in err
    # TLS is validated as the JAX package validates it, and a platform
    # the port does not serve stops the server before it listens.
    for text, msg in (('tls_certificate = "x.pem"\n',
                       "tls_certificate and tls_key must be set together"),
                      ('platform = "tpu"\n', "platform 'tpu'")):
        bad = tmp_path / "bad.toml"
        bad.write_text('bind = "127.0.0.1:0"\n' + text)
        res = subprocess.run(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-c",
             str(bad), "--device", "cpu"], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and msg in res.stderr, res.stderr
