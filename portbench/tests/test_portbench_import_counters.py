"""The readers of the import builder's counters (``import_bulk_share``,
``taxi_bits_import_s``) on a fake ``env``: they read the holder's
summed counters at the window's open, and nothing where the program has
no such counters."""

import types

import numpy as np
import pytest

from portbench import harness


def env_of(holder):
    return types.SimpleNamespace(api=types.SimpleNamespace(holder=holder))


def read(name, holder, after=None):
    """The reader's value over a window whose open saw ``holder`` and
    whose close saw ``after`` (the same holder where None)."""
    r = harness.metric_reader(name)
    snap = (r.at_window(env_of(holder)),
            r.at_window(env_of(holder if after is None else after)))
    return r.read(types.SimpleNamespace(snaps={name: snap}))


class Counted:
    """A holder with the port's import counters."""

    def __init__(self, sorted_calls, batch_calls, seconds):
        self.stats = {"sorted_calls": sorted_calls,
                      "batch_calls": batch_calls, "seconds": seconds}

    def import_stats(self):
        return dict(self.stats)


@pytest.mark.parametrize("name", ["import_bulk_share", "taxi_bits_import_s"])
def test_a_program_without_the_counters_reads_nothing(name):
    assert read(name, object()) is None


def test_share_is_batch_calls_over_sorted_calls_at_the_open():
    assert read("import_bulk_share", Counted(192, 144, 80.0),
                Counted(200, 200, 90.0)) == pytest.approx(75.0)
    assert read("import_bulk_share", Counted(0, 0, 3.0)) is None


def test_import_seconds_are_the_counter_at_the_open():
    assert read("taxi_bits_import_s", Counted(2, 2, 41.5),
                Counted(2, 2, 99.0)) == pytest.approx(41.5)


def test_readers_over_a_port_holder():
    """A CPU holder after a first load of a 10,000-row field and a
    narrow one: one sorted call, on the batch path; seconds counted."""
    from pilosa_tpu_torch import Holder
    h = Holder(device="cpu")
    idx = h.create_index("i")
    rng = np.random.default_rng(3)
    cols = np.arange(1 << 18, dtype=np.uint64)
    idx.create_field("grid").import_bits(
        rng.integers(0, 10_000, len(cols)).astype(np.uint64), cols)
    idx.create_field("cab").import_bits(
        rng.integers(0, 2, len(cols)).astype(np.uint64), cols)
    assert read("import_bulk_share", h) == 100.0
    assert read("taxi_bits_import_s", h) > 0
