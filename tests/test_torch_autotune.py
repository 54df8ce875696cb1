"""The port's geometry autotuner (``utils/autotune``) and the tuned
geometry (``Geometry.tuned``) against the JAX package's, on the CPU:
candidates and the prune, the whole search with injected cost and
measure functions (winner, pruned set, identity rejections, record),
the real chunk-scan cost and measurer at a small stimulus, and the
``autotune`` subcommand, which writes its record where it is told and
leaves the repo's files alone.
"""

import hashlib
import json
import os

import numpy as np

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.utils import autotune as R_at, geometry as R_geo
from ziria_tpu_torch.runtime import cli
from ziria_tpu_torch.utils import autotune, geometry

H100 = "NVIDIA H100 80GB HBM3"
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _cost(geo):
    """A stand-in cost: overlap makes the halved chunk dearer."""
    owned = geo.chunk_len - geo.frame_len
    return {"bytes_per_sample": 8.0 * geo.chunk_len / owned,
            "flops_per_sample": 100.0 + (5.0 if geo.fused_demap else 0.0)}


def _measure(geo):
    """A stand-in measurer: chunk 32768 diverges (rejected), the longer
    chunks and fused are faster, radix 4 is the default's speed."""
    sps = geo.chunk_len / 8.0 * (1.5 if geo.fused_demap else 1.0)
    fp = ("diverged",) if geo.chunk_len == 32768 else ("same",)
    return {"sps": sps, "fps": sps / 1000.0, "p50_ms": 1.0,
            "p99_ms": 2.0, "fingerprint": fp}


def _search(mod, path):
    logs = []
    out = mod.run(cost_fn=_cost, measure_fn=_measure, path=path,
                  device_kind=H100, platform="cuda", log=logs.append)
    return out, logs


def test_candidates_and_prune_equal_the_reference():
    base, r_base = geometry.Geometry().resolve(), R_geo.Geometry().resolve()
    assert base.as_dict() == r_base.as_dict()
    got = autotune.default_candidates(base)
    want = R_at.default_candidates(r_base)
    assert [(lb, g.as_dict()) for lb, g in got] == \
        [(lb, g.as_dict()) for lb, g in want]
    surv, rej = autotune.prune(got, _cost(base), _cost)
    r_surv, r_rej = R_at.prune(want, _cost(r_base), _cost)
    assert [s[0] for s in surv] == [s[0] for s in r_surv]
    assert rej == r_rej and [r["label"] for r in rej] == ["chunk4096",
                                                           "fused_demap",
                                                           "chunk16384_fused"]


def test_search_equals_the_reference_and_tuned_reproduces_it(tmp_path):
    p, rp = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    got, logs = _search(autotune, p)
    want, r_logs = _search(R_at, rp)
    for k in ("winner", "geometry", "sps_tuned", "baseline_sps", "speedup",
              "device_kind", "platform", "candidates", "pruned",
              "identity_rejected"):
        assert got[k] == want[k], k
    assert got["identity_rejected"] == ["chunk32768"]
    assert got["winner"] == "chunk16384"
    assert [m["label"] for m in got["measured"]] == \
        [m["label"] for m in want["measured"]]
    assert len(logs) == len(r_logs) and "REJECTED" in logs[2]
    rec = [json.loads(ln) for ln in open(p)]
    assert len(rec) == 1 and rec[0]["stage"] == "autotune"
    assert set(rec[0]) == set(json.loads(open(rp).read()))
    tuned = geometry.Geometry.tuned(H100, path=p)
    assert tuned.as_dict() == got["geometry"]
    # the reference's reader takes the port's record too
    assert R_geo.Geometry.tuned(H100, path=p).as_dict() == got["geometry"]
    # another card, a missing file or a broken line: the default
    assert geometry.Geometry.tuned("other", path=p) == geometry.Geometry()
    assert geometry.Geometry.tuned(H100, path=str(tmp_path / "none")) == \
        geometry.Geometry()
    with open(p, "a") as f:
        f.write("{broken\n")
    assert geometry.Geometry.tuned(H100, path=p).as_dict() == \
        got["geometry"]


def test_chunk_cost_and_measurer_on_the_cpu():
    base = geometry.Geometry().resolve()
    cost = {cl: autotune.stream_chunk_cost(base.replace(chunk_len=cl),
                                           "cpu")
            for cl in (4096, 8192, 16384)}
    assert cost[4096]["bytes_per_sample"] > \
        cost[8192]["bytes_per_sample"] * (1 + autotune.PRUNE_SLACK)
    assert cost[16384]["bytes_per_sample"] < cost[8192]["bytes_per_sample"]
    m = autotune.Measurer(n_frames=2, n_bytes=12, reps=1, device="cpu")
    a, b = m(base), m(base.replace(viterbi_radix=4))
    assert a["sps"] > 0 and a["fps"] > 0 and "cuda_sps" not in a
    assert a["p50_ms"] is not None
    assert len(a["fingerprint"][0]) == 2 and len(a["fingerprint"][1]) == 2
    assert a["fingerprint"] == b["fingerprint"]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_autotune_subcommand_records_where_told(tmp_path, monkeypatch,
                                               capsys):
    traj = os.path.join(ROOT, "BENCH_TRAJECTORY.jsonl")
    before = _sha(traj)
    own = geometry.env_trajectory_path()
    had_own = os.path.exists(own)
    monkeypatch.setattr(autotune, "stream_chunk_cost",
                        lambda geo, device: _cost(geo))
    monkeypatch.setattr(autotune, "Measurer",
                        lambda **kw: _measure)
    ledger = str(tmp_path / "tuned.jsonl")
    assert cli.main(["autotune", "--frames", "8", "--reps", "1",
                     "--platform=cpu", "--ledger", ledger]) == 0
    out = capsys.readouterr().out
    assert "reproduces the winner" in out
    head = json.loads(out.splitlines()[-2])
    assert head["winner"] == "chunk16384" and head["platform"] == "cpu"
    assert autotune.MAIN_RESULT["identity_rejected"] == ["chunk32768"]
    assert len(open(ledger).read().splitlines()) == 1
    assert cli.main(["autotune", "--platform=cpu", "--dry-run"]) == 0
    assert _sha(traj) == before
    assert os.path.exists(own) == had_own
    assert os.path.basename(own) == geometry.TUNED_BASENAME
    monkeypatch.setenv("ZIRIA_TORCH_TUNED", ledger)
    assert geometry.env_trajectory_path() == ledger
    assert np.isclose(head["speedup"], 2.0)
