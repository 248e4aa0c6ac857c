"""The port's multi-process dryrun (``parallel/multihost.py``) on the
CPU: two child processes join one gloo process group on a loopback
port, each holds its half of the JAX dryrun's ``[8, 8, 512]`` banks
(``default_rng(123)``) as a 4-part local mesh, reduces the per-row
``|a ∧ b|`` over its parts and then across processes, and checks it
against numpy. The counts equal those of the JAX package's dryrun
model; the server's ``jax_*`` keys reach ``torch.distributed`` only
with more than one process."""

import subprocess
import sys

import numpy as np
import pytest

from pilosa_tpu_torch.parallel import multihost

ROOT = __file__.rsplit("/tests/", 1)[0]


def test_banks_are_the_jax_dryruns():
    from pilosa_tpu.parallel import multihost as jmh
    a, b = multihost.banks()
    assert a.shape == (jmh.ROWS, jmh.SHARDS, jmh.WORDS)
    rng = np.random.default_rng(123)
    assert np.array_equal(a, rng.integers(0, 2**32, a.shape,
                                          dtype=np.uint32))
    assert np.array_equal(b, rng.integers(0, 2**32, b.shape,
                                          dtype=np.uint32))


@pytest.mark.parametrize("processes", [2, 1])
def test_gloo_dryrun_exits_zero(processes):
    """``python -m pilosa_tpu_torch.parallel.multihost --backend gloo
    --device cpu``: every child checks out; the parent says OK."""
    out = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.parallel.multihost",
         "--backend", "gloo", "--device", "cpu", "--processes",
         str(processes), "--timeout", "50"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    oks = [ln for ln in out.stdout.splitlines()
           if ln.startswith("multihost child") and ln.endswith("...")
           and ": OK counts=" in ln]
    assert len(oks) == processes, out.stdout
    assert f"multihost dryrun: OK ({processes} processes" in out.stdout


def test_backend_follows_the_device_and_init_needs_processes():
    from pilosa_tpu_torch.cli.main import init_distributed
    from pilosa_tpu_torch.utils.config import load_config
    import torch
    import torch.distributed as dist
    assert multihost.backend_for("cpu") == "gloo"
    assert multihost.backend_for("cuda") == "nccl"
    assert multihost.backend_for("cuda:0") == "nccl"
    # One process (the default) initialises nothing.
    cfg = load_config(overrides={"jax_coordinator": "127.0.0.1:1"},
                      environ={})
    init_distributed(cfg, torch.device("cpu"))
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process id"):
        multihost.init_process_group("127.0.0.1:1", 2, -1, "cpu")
