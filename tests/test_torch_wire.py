"""The port's wire codec (``pilosa_tpu_torch/server/wire.py``) and shard
placement (``pilosa_tpu_torch/parallel/hashing.py``) against the JAX
package's, on the CPU: ``dumps`` writes the JAX codec's bytes for the
values of ``tests/test_wire.py`` and for generated ones (u64 edges,
mixed numeric lists, numpy arrays, nested dicts), ``loads`` reads the
JAX codec's bytes back to equal values, malformed input raises
``WireError`` in the same cases, and ``shard_nodes`` places every
(index, shard < 2,000, nodes 1-7, replicas 1-3) as the JAX package
does. A torch tensor never reaches the encoder: it raises
``TypeError``."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pilosa_tpu.parallel import hashing as jhash
from pilosa_tpu.server import wire as jwire

from pilosa_tpu_torch.parallel import hashing as phash
from pilosa_tpu_torch.server import wire as pwire

VALUES = [
    None, True, False, 0, -1, 42, 2**62, -(2**62), 3.5, -0.0,
    "", "héllo", b"", b"\x00\xffraw",
    [], [1, 2, 3], [0, 2**20, 2**40], list(range(1000)),
    [-5, 7, -9], ["a", 1, None, True],
    {}, {"a": 1}, {"results": [{"columns": [1, 2, 3], "attrs": {"x": "y"}}]},
    {"rows": [1, 1, 2], "columns": [5, 6, 7], "shard": 0},
    [{"id": 3, "count": 2}, {"id": 4, "count": 1}],
    {"nested": {"deep": [[1], [2, 3], []]}},
    2**64 - 1, [2**64 - 1, 1], [2**64 - 1], -(2**63), [-(2**63), 2**63 - 1],
    [True, False], [1, 2.5], [1, True], [0, None, 3],
    np.array([1, 5, 9], dtype=np.uint64), np.array([-3, 0, 3], np.int32),
    {"columns": np.arange(7, dtype=np.uint64)}, np.float64(2.5),
    np.int64(-7), np.array([0.5, 1.5]),
]


@pytest.mark.parametrize("v", VALUES, ids=range(len(VALUES)))
def test_dumps_bytes_equal_jax_and_loads_back(v):
    raw = pwire.dumps(v)
    assert raw == jwire.dumps(v)
    assert pwire.loads(raw) == jwire.loads(raw)


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2**63), max_value=2**64 - 1)
            | st.sampled_from([0, 2**63 - 1, 2**63, 2**64 - 1, -(2**63)])
            | st.floats(allow_nan=False) | st.text(max_size=8)
            | st.binary(max_size=8))
_arrays = st.builds(
    lambda xs, dt: np.array(xs, dtype=dt),
    st.lists(st.integers(min_value=0, max_value=2**15 - 1), max_size=20),
    st.sampled_from([np.uint64, np.int64, np.int32, np.uint16]))
_values = st.recursive(
    _scalars | _arrays,
    lambda inner: st.lists(inner, max_size=6)
    | st.dictionaries(st.text(max_size=6), inner, max_size=5),
    max_leaves=30)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_generated_values_encode_like_jax(v):
    raw = pwire.dumps(v)
    assert raw == jwire.dumps(v)
    assert pwire.loads(raw) == jwire.loads(raw)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(min_value=-(2**63), max_value=2**64 - 1),
                min_size=1, max_size=40))
def test_integer_lists_at_the_64_bit_edges(xs):
    assert pwire.dumps(xs) == jwire.dumps(xs)
    assert pwire.loads(jwire.dumps(xs)) == xs


BAD = [b"nope", b"", b"PW1", b"PW1\x00", b"PW1\x00\x07",
       b"PW1\x00\x08\x01\x00\x00", b"PW1\x00\x03\x01",
       b"PW1\x00\x05\xff\xff\xff\xff", b"PW1\x00\x0c",
       b"PW1\x00\x05\x02\x00\x00\x00\xff\xfe",
       b"PW1\x00\x09\x02\x00\x00\x00" + b"\x00" * 9,
       jwire.dumps(1) + b"x", jwire.dumps({"c": list(range(50))})[:-5]]


@pytest.mark.parametrize("raw", BAD, ids=range(len(BAD)))
def test_malformed_input_raises_like_jax(raw):
    with pytest.raises(jwire.WireError):
        jwire.loads(raw)
    with pytest.raises(pwire.WireError):
        pwire.loads(raw)


@pytest.mark.parametrize("v", [1 << 70, -(1 << 63) - 1, object(), {1, 2},
                               np.zeros((2, 2), np.int64)])
def test_unencodable_values_raise_typeerror_like_jax(v):
    with pytest.raises(TypeError):
        jwire.dumps(v)
    with pytest.raises(TypeError):
        pwire.dumps(v)


def test_torch_values_never_reach_the_encoder():
    import torch
    for v in (torch.tensor([1, 2]), torch.tensor(3), [torch.tensor(1)]):
        with pytest.raises(TypeError):
            pwire.dumps(v)


def test_fnv_partition_and_jump_hash_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(500):
        raw = rng.bytes(int(rng.integers(0, 20)))
        assert phash.fnv64a(raw) == jhash.fnv64a(raw)
        key = int(rng.integers(0, 2**63))
        n = int(rng.integers(1, 50))
        assert phash.jump_hash(key, n) == jhash.jump_hash(key, n)
    for index in ("i", "taxi", "héllo"):
        for shard in (0, 1, 255, 2**32, 2**63):
            assert phash.partition(index, shard) == \
                jhash.partition(index, shard)
    assert phash.jump_hash(5, 0) == jhash.jump_hash(5, 0) == -1


@pytest.mark.parametrize("n_nodes", range(1, 8))
def test_shard_nodes_match_jax(n_nodes):
    for index in ("taxi", "d", "stars"):
        for replicas in (1, 2, 3):
            got = [phash.shard_nodes(index, s, n_nodes, replicas)
                   for s in range(2000)]
            want = [jhash.shard_nodes(index, s, n_nodes, replicas)
                    for s in range(2000)]
            assert got == want, (index, n_nodes, replicas)
