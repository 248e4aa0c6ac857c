"""The port's popcount kernels: their plain versions against the JAX
package's Pallas kernels (interpret mode, W = 32768) and jnp popcount
(trimmed W), exact equality; the wrappers' CPU routing and refusals; the
CUDA kernels themselves on a card (marked gpu, skipped without one)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.ops.bitset import popcount as jnp_popcount
from pilosa_tpu_torch.ops import build, kernels
from pilosa_tpu_torch.ops.bitset import WORDS_PER_SHARD, to_tensor

CPU = torch.device("cpu")


def _bank(seed, shape, fill):
    rng = np.random.default_rng(seed)
    if fill == "zeros":
        return np.zeros(shape, np.uint32)
    if fill == "ones":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    b = rng.integers(0, 2**32, shape, dtype=np.uint32)
    if fill == "sparse":
        b &= rng.integers(0, 2**32, shape, dtype=np.uint32)
        b &= rng.integers(0, 2**32, shape, dtype=np.uint32)
    return b


def _np(t):
    return t.numpy().astype(np.int64)


@pytest.mark.parametrize("fill", ["zeros", "sparse", "dense", "ones"])
def test_bank_row_counts_ref_matches_pallas(fill):
    bank = _bank(1, (3, 2, WORDS_PER_SHARD), fill)
    want = np.asarray(pk.bank_row_counts(jnp.asarray(bank), interpret=True))
    got = kernels.bank_row_counts_ref(to_tensor(bank, CPU))
    np.testing.assert_array_equal(_np(got), want.astype(np.int64))


@pytest.mark.parametrize("fill", ["zeros", "dense", "ones"])
def test_bank_row_counts_masked_ref_matches_pallas(fill):
    bank = _bank(2, (3, 2, WORDS_PER_SHARD), "dense")
    filt = _bank(3, (2, WORDS_PER_SHARD), fill)
    wi, wr = pk.bank_row_counts_masked(jnp.asarray(bank), jnp.asarray(filt),
                                       interpret=True)
    gi, gr = kernels.bank_row_counts_masked_ref(to_tensor(bank, CPU),
                                                to_tensor(filt, CPU))
    np.testing.assert_array_equal(_np(gi), np.asarray(wi).astype(np.int64))
    np.testing.assert_array_equal(_np(gr), np.asarray(wr).astype(np.int64))


def test_bsi_plane_counts_ref_matches_pallas():
    planes = _bank(4, (4, 2, WORDS_PER_SHARD), "dense")
    mask = _bank(5, (2, WORDS_PER_SHARD), "sparse")
    want = np.asarray(pk.bsi_plane_counts(jnp.asarray(planes),
                                          jnp.asarray(mask), interpret=True))
    got = kernels.bsi_plane_counts_ref(to_tensor(planes, CPU),
                                       to_tensor(mask, CPU))
    np.testing.assert_array_equal(_np(got), want.astype(np.int64))


TRIMMED = [(5, 3, 128), (5, 3, 2048), (2, 3, 6144), (4, 1, 33), (1, 2, 1)]


@pytest.mark.parametrize("shape", TRIMMED)
def test_refs_match_jnp_at_trimmed_widths(shape):
    R, S, W = shape
    bank = _bank(6, shape, "dense")
    filt = _bank(7, (S, W), "dense")
    jbank, jfilt = jnp.asarray(bank), jnp.asarray(filt)
    raw = np.asarray(jnp_popcount(jbank, axis=(-2, -1))).astype(np.int64)
    inter = np.asarray(jnp_popcount(jbank & jfilt, axis=(-2, -1))
                       ).astype(np.int64)
    tbank, tfilt = to_tensor(bank, CPU), to_tensor(filt, CPU)
    np.testing.assert_array_equal(_np(kernels.bank_row_counts_ref(tbank)),
                                  raw)
    gi, gr = kernels.bank_row_counts_masked_ref(tbank, tfilt)
    np.testing.assert_array_equal(_np(gi), inter)
    np.testing.assert_array_equal(_np(gr), raw)
    np.testing.assert_array_equal(
        _np(kernels.bsi_plane_counts_ref(tbank, tfilt)), inter)


def test_wrappers_take_plain_path_on_cpu_without_launching():
    bank = to_tensor(_bank(8, (3, 2, 256), "dense"), CPU)
    filt = to_tensor(_bank(9, (2, 256), "dense"), CPU)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.bank_row_counts(bank),
                       kernels.bank_row_counts_ref(bank))
    for g, w in zip(kernels.bank_row_counts_masked(bank, filt),
                    kernels.bank_row_counts_masked_ref(bank, filt)):
        assert torch.equal(g, w)
    assert torch.equal(kernels.bsi_plane_counts(bank, filt),
                       kernels.bsi_plane_counts_ref(bank, filt))
    assert kernels.LAUNCHES == before
    assert kernels.bank_row_counts(bank).dtype == torch.int64


@pytest.mark.parametrize("case", ["dtype", "rank", "filter_shape",
                                  "filter_dtype", "meta_device"])
def test_wrappers_refuse_bad_operands(case):
    bank = torch.zeros((2, 3, 64), dtype=torch.int32)
    filt = torch.zeros((3, 64), dtype=torch.int32)
    if case == "dtype":
        with pytest.raises(TypeError):
            kernels.bank_row_counts(bank.to(torch.int64))
    elif case == "rank":
        with pytest.raises(ValueError):
            kernels.bank_row_counts(bank[0])
    elif case == "filter_shape":
        with pytest.raises(ValueError):
            kernels.bank_row_counts_masked(bank, filt[:, :32])
    elif case == "filter_dtype":
        with pytest.raises(TypeError):
            kernels.bsi_plane_counts(bank, filt.to(torch.int16))
    else:
        # Neither CPU nor CUDA: no plain-version fallback either.
        with pytest.raises(ValueError):
            kernels.bank_row_counts(bank.to("meta"))


def test_c_entry_points_match_build_signatures():
    names = set()
    for source in build.SOURCES:
        src = (build.CSRC_DIR / source).read_text()
        exported = src[src.index('extern "C"'):]
        names |= set(re.findall(r'^(?:extern "C" )?int (\w+)\(', exported,
                                re.M))
    # launch_floor launches an empty kernel, the yardstick chip_smoke.py
    # times launch-bound kernels against; it counts no launches.
    assert names == set(build.SIGNATURES) == \
        set(kernels.LAUNCHES) | {"launch_floor"}


def test_c_entry_arity_matches_build_signatures():
    """Each C entry takes as many arguments as ctypes is told it does."""
    for source in build.SOURCES:
        src = (build.CSRC_DIR / source).read_text()
        exported = src[src.index('extern "C"'):]
        for name, params in re.findall(r'^(?:extern "C" )?int (\w+)\(([^)]*)\)',
                                       exported, re.M):
            assert len(params.split(",")) == len(build.SIGNATURES[name]), \
                name


def test_library_path_is_keyed_on_source_hash():
    path = build.library_path()
    assert path.parent.name == build.source_hash()
    assert path.parent.parent == build.BUILD_DIR
    assert len(build.source_hash()) == 16


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 96, WORDS_PER_SHARD),
                                   (8, 96, WORDS_PER_SHARD), (5, 3, 33),
                                   (5, 3, 128), (5, 3, 2048), (5, 3, 6144)])
def test_cuda_kernels_match_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    R, S, W = shape
    bank = to_tensor(_bank(10, shape, "dense"), dev)
    filt = to_tensor(_bank(11, (S, W), "dense"), dev)
    sweeps = ("bank_row_counts", "bank_row_counts_masked",
              "bsi_plane_counts")
    launches = {k: kernels.LAUNCHES[k] for k in sweeps}
    assert torch.equal(kernels.bank_row_counts(bank),
                       kernels.bank_row_counts_ref(bank))
    for g, w in zip(kernels.bank_row_counts_masked(bank, filt),
                    kernels.bank_row_counts_masked_ref(bank, filt)):
        assert torch.equal(g, w)
    assert torch.equal(kernels.bsi_plane_counts(bank, filt),
                       kernels.bsi_plane_counts_ref(bank, filt))
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] == launches[k] + 1 for k in launches)
