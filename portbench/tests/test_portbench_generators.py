"""Each generator repeats for one seed and differs for another."""

import json

import numpy as np
import pytest

from portbench import harness
from portbench.datasets import fingerprint
from portbench.gen import Traffic, load_mix


def _cfg(name, **over):
    with open(harness.BENCH_DIR / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("mod,cfg", [
    (fingerprint, _cfg("fingerprint-10m", molecules=4_000,
                       load_chunk=1_500)),
])
def test_dataset_repeats_for_a_seed_and_differs_for_another(mod, cfg):
    a = mod.generate(cfg, 2**31 + 5, "cpu")
    b = mod.generate(cfg, 2**31 + 5, "cpu")
    c = mod.generate(cfg, 2**31 + 6, "cpu")
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a)


def test_fingerprint_families_share_their_scaffold():
    cfg = _cfg("fingerprint-10m", molecules=2_000, load_chunk=700)
    pos = fingerprint.generate(cfg, 3, "cpu")["positions"]
    assert pos.shape == (2_000, cfg["draws"])
    assert (np.diff(pos.astype(int), axis=1) >= 0).all()
    # Two members of one family share far more bits than two strangers.
    same = len(np.intersect1d(pos[0], pos[1]))
    other = len(np.intersect1d(pos[0], pos[cfg["family"]]))
    assert same >= 10 > other


@pytest.mark.parametrize("mix", ["fingerprint-similarity"])
def test_traffic_repeats_for_a_seed_and_differs_for_another(mix):
    spec = load_mix(str(harness.BENCH_DIR / "traffic" / f"{mix}.json"))
    sizes = {"molecules": 10_000_000}
    a = [Traffic(spec, sizes, 2**31 + 9).request("window", c, s)
         for c in range(3) for s in range(5)]
    b = [Traffic(spec, sizes, 2**31 + 9).request("window", c, s)
         for c in range(3) for s in range(5)]
    c = [Traffic(spec, sizes, 2**31 + 10).request("window", c, s)
         for c in range(3) for s in range(5)]
    assert a == b
    assert a != c
    assert len(set(a)) == len(a)  # no two requests alike
