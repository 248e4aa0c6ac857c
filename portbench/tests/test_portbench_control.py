"""The control (the reference in its lower-resolution form in the
program's place, its answers judged by the harness's own check) comes
out not correct, at sizes a test run holds; on the chip it runs at the
cell's own size (``portbench/control.py``)."""

import pytest

from portbench import control

SIZES = {
    "fingerprint-similarity": ({"molecules": 20_000, "load_chunk": 5_000},
                               50),
}


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_is_not_correct(cell):
    over, n = SIZES[cell]
    got = control.readings(cell, 2**31 + 3, n, "cpu", over)
    assert got["requests"] == n
    assert got["correct"] is False
    assert got["checked"]["mismatched"]["value"] > 0
    assert got["checked"]["compared"]["value"] == n
