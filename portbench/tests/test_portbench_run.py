"""The harness end to end at a small size on the CPU (the port's
reference paths), skipping only its look for a card; and the faults the
check has to catch, each planted in the program underneath."""

import json

import pytest

from portbench import harness

CELL = "fingerprint-similarity"
SMALL = {"molecules": 20_000, "load_chunk": 5_000}
SEED = 2**31 + 17


def run(trace=False, seconds=2.0, rate=None, monkeypatch=None):
    if rate is not None:  # enough requests at once to form batches
        load = harness.load_mix
        monkeypatch.setattr(harness, "load_mix",
                            lambda path: dict(load(path), rate_per_s=rate))
    out = harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                           overrides=SMALL, log=lambda m: None)
    json.dumps(out)  # the result line is plain JSON
    return out


def test_cell_runs_end_to_end_and_is_correct():
    out = run()
    assert out["correct"] is True
    assert out["checked"]["compared"]["value"] > 0
    assert out["checked"]["mismatched"]["value"] == 0
    assert list(out)[-1] == "checked"
    # The CPU has no device peak to read, so no device_peak_gib here.
    assert set(out["metrics"]) == {"setup_s"}
    assert out["attempted"] >= out["failed"] == 0


def test_traced_run_reports_per_layer_metrics():
    out = run(trace=True)
    assert out["correct"] is True
    for name in ("latency_p50_ms", "request_p90_ms", "http_floor_ms",
                 "requests_per_batch", "import_s", "warm_s",
                 "mega_calls_share"):
        assert name in out["metrics"]
    assert "setup_s" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_one_altered_answer_turns_correct_false(monkeypatch):
    """An answer altered where the executor shapes it: the first response
    after the warm-up (16 clients x 4 requests) gets one count wrong."""
    from pilosa_tpu_torch.executor.executor import Executor
    shape = Executor.shape_response
    seen = []

    def altered(self, index_name, results, opts=None):
        resp = shape(self, index_name, results, opts)
        seen.append(1)
        if len(seen) == 65:
            pairs = resp["results"][0]
            wrong = [dict(pairs[0], count=pairs[0]["count"] + 1)] \
                + pairs[1:] if pairs else [{"id": 0, "count": 1}]
            resp = dict(resp, results=[wrong] + resp["results"][1:])
        return resp

    monkeypatch.setattr(Executor, "shape_response", altered)
    out = run()
    assert out["correct"] is False
    assert out["checked"]["mismatched"]["value"] == 1


def test_half_of_a_batch_given_the_others_answers_turns_correct_false(
        monkeypatch):
    """The coalescer's fan-back broken: the second half of a batch's
    requests get the first request's answer."""
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    resolve = QueryCoalescer._resolve

    def broken(owner, shaped):
        half = len(shaped) // 2
        resolve(owner, list(shaped[:len(shaped) - half])
                + [shaped[0]] * half)

    monkeypatch.setattr(QueryCoalescer, "_resolve", staticmethod(broken))
    out = run(rate=200.0, monkeypatch=monkeypatch)
    assert out["correct"] is False
    assert out["checked"]["mismatched"]["value"] > 0


def test_an_import_that_leaves_the_state_unchanged_turns_correct_false(
        monkeypatch):
    """The bulk import returns without a change after its first chunk, so
    most molecules are never stored."""
    from pilosa_tpu_torch.core.field import Field
    import_bits = Field.import_bits
    calls = []

    def first_only(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return import_bits(self, *args, **kwargs)

    monkeypatch.setattr(Field, "import_bits", first_only)
    out = run()
    assert out["correct"] is False
    assert out["checked"]["mismatched"]["value"] > 0


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = harness.run_cell(CELL, SEED, 2.0, False, device="cuda",
                           overrides=SMALL, log=lambda m: None)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
