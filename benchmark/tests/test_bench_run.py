"""Whole runs on the CPU at a small size: the result line's keys, and
the comparison refusing a timed path broken underneath. The harness's
look for a card is skipped (``require_card=False``); everything else of
a run is driven as on the card."""

import argparse
import json

import numpy as np
import pytest

from benchmark import run
from benchmark.tests.smallcells import SMALL

SEED = 2 ** 31 + 17
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(wl, trace=0, seconds=1.0):
    args = argparse.Namespace(workload=wl, seed=SEED, seconds=seconds,
                              trace=trace)
    return run.run(args, device="cpu", require_card=False,
                   overrides=SMALL[wl])


def test_the_result_line_has_the_contracts_keys():
    res, numbers, window = _run("batch_mixed_512")
    line = json.loads(json.dumps(res))
    assert list(line) == KEYS              # "checks" last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 8 * window["calls"] + 8 * 2
    assert set(line["metrics"]) == {"rx_samples_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    assert line["checks"] == {n: {"value": v, "limit": lim}
                              for n, v, lim in numbers}
    assert run.forbidden_modules() == []


def test_a_traced_fleet_run_reports_its_host_metrics():
    res, _n, _w = _run("fleet32_busy", trace=1, seconds=2.0)
    assert res["correct"] is True
    # no profiler trace on the CPU: only the host-clock readers read
    assert set(res["metrics"]) <= {"fleet.step_ms_p95",
                                   "fleet.frame_latency_p95_ms"}


def _stale(real):
    """A step that returns its state unchanged: every call after the
    first answers with the first call's results."""
    first = []

    def f(caps, **kw):
        if not first:
            first.append(real(caps, **kw))
        return first[0]
    return f


def _half(real):
    """Half of the batch left out."""
    return lambda caps, **kw: real(caps[:len(caps) // 2], **kw)


def _altered(real):
    """An answer altered where it is produced: one PSDU bit flipped."""
    def f(caps, **kw):
        out = list(real(caps, **kw))
        bits = np.array(out[1].psdu_bits, copy=True)
        bits[5] ^= 1
        out[1] = out[1]._replace(psdu_bits=bits)
        return out
    return f


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_a_broken_batch_is_not_correct(monkeypatch, fault):
    from ziria_tpu_torch.backend import framebatch

    monkeypatch.setattr(framebatch, "receive_many",
                        fault(framebatch.receive_many))
    res, _n, _w = _run("batch_mixed_512")
    assert res["correct"] is False and res["failed"] > 0


def _fleet_stale(real):
    """A chunk-step that returns its state unchanged: the slabs are
    dropped, nothing advances."""
    return lambda self, slabs: []


def _fleet_half(real):
    """Half of the streams left out of every chunk-step."""
    def f(self, slabs):
        n = len(slabs) // 2
        return real(self, list(slabs[:n])
                    + [s[:0] for s in slabs[n:]])
    return f


def _fleet_altered(real):
    def f(self, slabs):
        out = real(self, slabs)
        if out:
            i, fr = out[0]
            bits = np.array(fr.result.psdu_bits, copy=True)
            bits[3] ^= 1
            out[0] = (i, fr._replace(
                result=fr.result._replace(psdu_bits=bits)))
        return out
    return f


@pytest.mark.parametrize("fault", [_fleet_stale, _fleet_half,
                                   _fleet_altered])
def test_a_broken_fleet_is_not_correct(monkeypatch, fault):
    from ziria_tpu_torch.backend import framebatch

    cls = framebatch.MultiStreamReceiver
    monkeypatch.setattr(cls, "push_many", fault(cls.push_many))
    res, _n, _w = _run("fleet32_busy", seconds=2.0)
    assert res["correct"] is False and res["failed"] > 0
