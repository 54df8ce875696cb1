"""The port's chaos-soak campaign (ziria_tpu_torch/tools/soak.py) and
windowed-decode BER study (tools/windowed_ber.py) against the repo's
``tools/soak.py`` and ``tools/windowed_ber.py``, on the CPU: the fault
draws spec for spec, the client streams and their oracle, in-process
fault rounds and a real SIGKILL round through every gate, and the
study's frames and windowed decode bit for bit with the guard's two
claims.
"""

import importlib.util
import os

import jax
import numpy as np
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_fleet import same_frames
from ziria_tpu.ops import viterbi as jviterbi, viterbi_pallas
from ziria_tpu_torch.tools import soak, windowed_ber

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20260804
ATOL = 3e-6             # streams: the reference's noise within 2 ulp


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_SOAK = _load("soak")
REF_BER = _load("windowed_ber")


def test_round_specs_equal_reference():
    assert (soak.N_BYTES, soak.GEO) == (REF_SOAK.N_BYTES, REF_SOAK.GEO)
    for menu in ("DISPATCH_MENU", "DATA_MENU", "IO_MENU"):
        assert getattr(soak, menu) == getattr(REF_SOAK, menu)
    # the campaign's draws: rounds r < 4 at seed + 17 r, dirty on odd
    # r, and the channel round's dirty draw at seed + 991
    draws = [(SEED + 17 * r, bool(r % 2)) for r in range(4)]
    draws.append((SEED + 991, True))
    for seed, dirty in draws:
        got = soak._round_specs(np.random.default_rng(seed), dirty)
        want = REF_SOAK._round_specs(np.random.default_rng(seed), dirty)
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
        assert type(got[0]).__module__.startswith("ziria_tpu_torch")


def test_clients_and_oracle_equal_reference():
    """The port's seeded streams, plain and urban, are the reference's
    (ticks, slab lengths, samples within ATOL), and the port's oracle
    is the reference's frame for frame."""
    for seed, profile in ((SEED, None), (SEED + 1, "urban")):
        got = soak._clients(3, 3, seed, channel_profile=profile,
                            device="cpu")
        want = REF_SOAK._clients(3, 3, seed, channel_profile=profile)
        assert [c.sid for c in got] == [c.sid for c in want]
        for g, w in zip(got, want):
            assert [(t, s.shape[0]) for t, s in g.schedule] == \
                [(t, s.shape[0]) for t, s in w.schedule]
            w_stream = np.asarray(w.stream)
            assert g.stream.shape == w_stream.shape
            assert float(np.abs(g.stream - w_stream).max()) <= ATOL
        if profile is None:
            oracle = soak._oracle(got, device="cpu")
            ref = REF_SOAK._oracle(want)
            assert sorted(oracle) == sorted(ref)
            for sid in oracle:
                same_frames(oracle[sid], ref[sid])
            assert sum(len(v) for v in oracle.values()) == 9


def test_clean_dirty_and_channel_rounds_pass_every_gate():
    """The campaign at the reference's CPU smoke size, no SIGKILL round:
    the warm pass, a clean round, a dirty round with the post-recovery
    budget pinned, and the urban channel round."""
    ev = soak.soak_stats(n_sessions=3, n_lanes=4, frames_per_session=3,
                         rounds=2, sigkill_rounds=0, device="cpu")
    assert ev["zero_crashes"] and ev["identity"] == "bit_identical"
    assert ev["oracle_frames"] == 9 and ev["recovery_rounds_timed"] == 3
    assert sorted(ev["recovery_s"]) == ["round-0", "round-1",
                                        "round-channel"]
    assert ev["recovery_p99_s"] <= 30.0 and ev["budget_checked"]
    post, = ev["post_recovery"]
    assert post["round"] == "round-1" and 0 < post["dpcs"] <= 2.0
    assert post["decode_dispatches"] > 0
    # on the CPU the wrappers run their plain versions and count nothing
    assert post["launches"] == {"acs": 0, "traceback": 0}
    assert (post["nvcc_builds"], post["library_loads"]) == (0, 0)
    assert ev["channel_round_frames"] > 0 and ev["faults_injected"] >= 1
    assert ev["kills"] == {"killed": 0, "kill_missed": 0}


def test_sigkill_round_with_a_cpu_child(tmp_path):
    """Real process death: the ``python -m ziria_tpu_torch.tools.soak
    --child`` serving process is SIGKILLed mid chunk-step; this process
    recovers from the directory it left, with the post-recovery budget
    pinned, and the union of both runs' frames, deduplicated by (sid,
    start), is the oracle's."""
    clients = soak._clients(3, 4, SEED, device="cpu")
    oracle = soak._oracle(clients, device="cpu")
    ev = soak.run_sigkill_round(clients, oracle, str(tmp_path / "kill"),
                                seed=SEED, n_lanes=4, frames_per_session=4,
                                tick_sleep=0.05, device="cpu")
    head = ev["child"]
    assert head["device"] == "cpu" and head["nvcc_builds"] == 0
    assert head["streams"] == soak._digest(clients)
    assert ev["killed"] or ev["kill_missed"]
    assert ev["frames_checked"] >= sum(len(v) for v in oracle.values())
    if ev["killed"] and not ev["kill_missed"]:
        assert ev["recovery_s"] > 0 and ev["pre_kill_frames"] >= 1
        assert ev["post_recovery"]["dpcs"] <= 2.0


def test_windowed_ber_equals_reference():
    """The study's frames are the reference's; the port's windowed
    decode with the scan decoder in its hook equals the reference's
    (lax.scan in its hook) bit for bit at 4 x 2048 bits, window 512,
    amplitudes 1.2 and 0.9 (the guard's seeds); the guard's two claims
    hold for the port; and the study runs end to end on the CPU."""
    def jscan(x):
        return jax.vmap(jviterbi.viterbi_decode)(x)

    for seed, amp in ((2026, 1.2), (7, 0.9)):
        msgs, llrs = windowed_ber.make_coded_frames(
            np.random.default_rng(seed), 4, 2048, amp)
        r_msgs, r_llrs = REF_BER.make_coded_frames(
            np.random.default_rng(seed), 4, 2048, amp)
        np.testing.assert_array_equal(msgs, r_msgs)
        np.testing.assert_array_equal(llrs, r_llrs)
        x = torch.from_numpy(llrs)
        exact = windowed_ber.scan_engine(x).numpy()
        win = windowed_ber.windowed(
            x, 96, _decode=windowed_ber.scan_engine).numpy()
        np.testing.assert_array_equal(exact, np.asarray(jscan(llrs)))
        np.testing.assert_array_equal(win, np.asarray(
            viterbi_pallas.viterbi_decode_batch_windowed(
                llrs, window=512, overlap=96, _decode=jscan)))
        if amp == 1.2:           # the operating point: identical
            np.testing.assert_array_equal(win, exact)
            assert (exact != msgs).mean() < 0.05
        else:                    # below the waterfall: no BER penalty
            ber_e, ber_w = (exact != msgs).mean(), (win != msgs).mean()
            assert abs(ber_w - ber_e) < 0.02 * max(ber_e, 1e-9) + 2e-3
    out = windowed_ber.main(device="cpu", n_frames=2, n_bits=1024)
    assert out["engine"] == "scan decoder via _decode"
    assert [p["llr_amp"] for p in out["points"]] == list(windowed_ber.AMPS)
    assert sorted(out["points"][0]["overlaps"]) == ["32", "64", "96"]
