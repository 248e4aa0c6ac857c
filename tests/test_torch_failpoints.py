"""The port's failpoints (``utils/failpoints.py``) against the JAX
package's, on the CPU: the spec parser, the registry's modes and count
exhaustion, the configuration string, and the server's single-node sites
(``api.query``, ``api.status``) and ``/internal/failpoints`` gate. Each
case runs one script through both packages and compares what they do and
their ``snapshot()`` documents. The static cluster's sites (the
internal client's and the heartbeat's) are registered with the API;
the resize pull's come with resize."""

import json
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import serve as jax_serve
from pilosa_tpu.server.api import ApiError as JaxApiError
from pilosa_tpu.utils import failpoints as jfp

from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.server.api import API, ApiError
from pilosa_tpu_torch.server.http import serve
from pilosa_tpu_torch.utils import failpoints as pfp

MODS = (jfp, pfp)


def _spec(s):
    return (s.mode, s.arg, s.remaining, s.raw)


@pytest.mark.parametrize("text", ["error", "errorx3", "delay(0.25)",
                                  "partition(:10102)x2", "drop"])
def test_parse_spec_forms(text):
    assert _spec(pfp.parse_spec(text)) == _spec(jfp.parse_spec(text))


@pytest.mark.parametrize("bad", [
    "explode", "", "error(x", "delay", "delay(abc)", "partition",
    "partition()", "errorx", "error x2",
])
def test_parse_spec_rejects(bad):
    for m in MODS:
        with pytest.raises(ValueError):
            m.parse_spec(bad)


def test_register_duplicate_raises():
    for m in MODS:
        reg = m.FailpointRegistry()
        reg.register("a.site")
        with pytest.raises(ValueError, match="registered twice"):
            reg.register("a.site")


def test_arm_unknown_site_raises():
    for m in MODS:
        reg = m.FailpointRegistry()
        with pytest.raises(KeyError, match="unknown failpoint"):
            reg.arm("nope", "error")
        with pytest.raises(KeyError):
            reg.disarm("nope")


def test_disarmed_fire_is_noop():
    snaps = []
    for m in MODS:
        reg = m.FailpointRegistry()
        site = reg.register("quiet")
        site.fire(uri="anything")
        assert site.hits == 0
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0] == {
        "sites": {"quiet": {"armed": None, "hits": 0}},
        "armed": 0, "fired": 0}


def test_error_drop_delay_partition_modes():
    snaps = []
    for m in MODS:
        reg = m.FailpointRegistry()
        err, drp, dly, par = (reg.register(n) for n in "edsp")
        reg.configure({"e": "error", "d": "drop", "s": "delay(0.01)",
                       "p": "partition(:9999)"}, env="")
        with pytest.raises(m.FailpointError):
            err.fire()
        with pytest.raises(m.FailpointDrop):
            drp.fire()
        t0 = time.perf_counter()
        dly.fire()
        assert time.perf_counter() - t0 >= 0.01
        par.fire(uri="http://h:1234/x")
        with pytest.raises(m.FailpointError):
            par.fire(uri="http://h:9999/x")
        assert issubclass(m.FailpointError, ConnectionError)
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]
    assert snaps[1]["fired"] == 4 and snaps[1]["sites"]["p"]["hits"] == 1


def test_count_exhaustion_self_disarms():
    snaps = []
    for m in MODS:
        reg = m.FailpointRegistry()
        site = reg.register("limited")
        reg.arm("limited", "errorx2")
        for _ in range(2):
            with pytest.raises(m.FailpointError):
                site.fire()
        site.fire()
        assert site.spec is None
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]
    assert snaps[1]["sites"]["limited"] == {"armed": None, "hits": 2}


def test_configure_env_string_and_unknown_name():
    for m in MODS:
        reg = m.FailpointRegistry()
        a = reg.register("a")
        reg.register("b")
        reg.configure({"a": "delay(0)"}, env="b=errorx1; a=error")
        assert a.spec is not None and a.spec.mode == "error"
        with pytest.raises(KeyError):
            reg.configure({"typo.site": "error"}, env="")


# ------------------------------------------------------- http surface


def zero_counts(monkeypatch, *registries):
    """The process-wide registries' hit and fire counts at zero for one
    test (restored after it): other test files fire the same sites, one
    package's registry only or both."""
    for reg in registries:
        monkeypatch.setattr(reg, "fired_total", 0)
        for site in reg._sites.values():
            monkeypatch.setattr(site, "hits", 0)


@pytest.fixture
def apis(tmp_path, monkeypatch):
    from pilosa_tpu.core.holder import Holder as JaxHolder
    zero_counts(monkeypatch, *(m.FAILPOINTS for m in MODS))
    jh = JaxHolder(str(tmp_path / "fp"))
    jh.open()
    pair = (JaxAPI(jh), API(Holder(device="cpu")))
    was = [m.FAILPOINTS.http_enabled for m in MODS]
    yield pair
    for m, w in zip(MODS, was):
        m.FAILPOINTS.disarm_all()
        m.FAILPOINTS.http_enabled = w
    jh.close()


def test_http_surface_gated(apis):
    for m, api, err in zip(MODS, apis, (JaxApiError, ApiError)):
        m.FAILPOINTS.http_enabled = False
        with pytest.raises(err) as ei:
            api.failpoints_snapshot()
        assert ei.value.status == 403
        with pytest.raises(err):
            api.failpoints_update({"arm": {"api.query": "error"}})
        m.FAILPOINTS.http_enabled = True
        assert {"api.query", "api.status"} <= \
            set(api.failpoints_snapshot()["sites"])
        out = api.failpoints_update({"arm": {"api.status": "delay(0)"}})
        assert out["sites"]["api.status"]["armed"] == "delay(0)"
        assert api.failpoints_update({"disarm_all": True})["armed"] == 0
        with pytest.raises(err) as ei:
            api.failpoints_update({"arm": {"nope": "error"}})
        assert ei.value.status == 400
    # The port registers exactly the single-node sites and the static
    # cluster's (the internal client's and the heartbeat's).
    assert set(pfp.FAILPOINTS.snapshot()["sites"]) == \
        {"api.query", "api.status", "client.connect", "client.read",
         "client.5xx", "client.torn_body", "heartbeat.probe"}


def test_http_route_serves_and_gates(apis):
    srvs = [jax_serve(apis[0], "localhost", 0, background=True),
            serve(apis[1], "localhost", 0, background=True)]
    try:
        for m, srv in zip(MODS, srvs):
            base = f"http://localhost:{srv.server_address[1]}"
            m.FAILPOINTS.http_enabled = True
            req = urllib.request.Request(
                base + "/internal/failpoints", method="POST",
                data=json.dumps({"arm": {"api.status": "errorx1"}}).encode())
            with urllib.request.urlopen(req, timeout=10) as resp:
                doc = json.loads(resp.read())
            assert doc["sites"]["api.status"]["armed"] == "errorx1"
            with urllib.request.urlopen(base + "/internal/failpoints",
                                        timeout=10) as resp:
                assert json.loads(resp.read())["armed"] == 1
            # The armed site fails /status once, then disarms itself.
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/status", timeout=10)
            assert ei.value.code == 500
            with urllib.request.urlopen(base + "/status", timeout=10) as r:
                assert json.loads(r.read())["state"] == "NORMAL"
            m.FAILPOINTS.http_enabled = False
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/internal/failpoints",
                                       timeout=10)
            assert ei.value.code == 403
    finally:
        for srv in srvs:
            srv.shutdown()
            srv.server_close()


def test_api_query_site_fails_queries(apis):
    """An armed ``api.query`` fails the query entry of both servers'
    APIs alike; disarmed, the same query answers."""
    out = []
    for m, api in zip(MODS, apis):
        api.holder.create_index("q").create_field("f")
        m.FAILPOINTS.arm("api.query", "errorx1")
        with pytest.raises(m.FailpointError):
            api.query("q", "Count(Row(f=1))")
        out.append((api.query("q", "Count(Row(f=1))"),
                    m.FAILPOINTS.snapshot()["sites"]["api.query"]))
        m.FAILPOINTS.disarm_all()
    assert out[1] == out[0] == ({"results": [0]},
                                {"armed": None, "hits": 1})
