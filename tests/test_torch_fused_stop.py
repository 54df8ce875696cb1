"""The stop rule of the two fused decode kernels of
ziria_tpu_torch/csrc/viterbi.cu, on the CPU (torch and numpy only).

``fused_acs_mixed_kernel`` and ``fused_acs_rate_kernel`` stop a frame's
sweep after the first renorm (a multiple of the cadence: 72 mixed,
spb * n_dbps known-rate) at or past the frame's bit count that leaves
all 64 metrics +0 bitwise, and write zero decision words and +0 metrics
from there on. Their front makes every soft pair at or past the bit
count a literal +0, whatever the symbols hold. A test-local emulation
of that rule on the plain sweep equals the full sweep of
``fused_acs_mixed_plain`` and ``fused_acs_rate_plain`` bit for bit
(decision words, final metrics as int32 bit patterns, traceback bits),
at radix 2 and 4. The plain versions equal the Pallas fused kernels in
interpret mode (tests/test_torch_fused_decode.py), so the rule is
chained to the reference.
"""

import numpy as np
import pytest
import torch

from chip_smoke import FUSED_EDGE as EDGE_LANES, FUSED_FULL as FULL, \
    FUSED_INF as INF, FUSED_LANES, FUSED_LONG as LONG, FUSED_NAN as NAN, \
    FUSED_QUIET as QUIET, FUSED_ZERO as ZERO, fused_edge_lanes, need_stop
from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
from ziria_tpu_torch.phy.wifi import params

PSDU_BYTES = 1000        # chip_smoke.py's frames
# the stop steps that chip_smoke.py's 1000-byte frames need, by rate
# (6 ... 54 Mbps): the first boundary at least 6 steps past the bits
WANT_MIXED = [8064, 8064, 8136, 8136, 8136, 8136, 8136, 8280]
WANT_RATE = [8064, 8064, 8160, 8136, 8160, 8208, 8256, 8424]


def _plain_sweep(llr: torch.Tensor, cadence: int, radix: int):
    """acs_plain's float32 sweep step for step, also returning the
    metrics after each renorm: (decisions, final metrics, [(boundary,
    metrics)])."""
    B, Tp = llr.shape[0], llr.shape[1]
    tab = vc._plain_tables(llr.device)
    step, k = (vc._step_plain, 1) if radix == 2 else (vc._pair_plain, 2)
    m = torch.full((B, 64), vc.NEG, dtype=torch.float32)
    m[:, 0] = 0
    decs = torch.empty((B, Tp, 64), dtype=torch.bool)
    seen = []
    for t in range(0, Tp, k):
        m, decs[:, t:t + k] = step(m, llr[:, t:t + k], tab, False)
        if (t + k) % cadence == 0:
            m = m - m.amax(dim=1, keepdim=True)
            seen.append((t + k, m))
    weights = 1 << torch.arange(8, dtype=torch.int32)
    packed = (decs.view(B, Tp, 8, 8).to(torch.int32) * weights).sum(-1)
    return packed.to(torch.uint8), m, seen


def _plus_zero(m: torch.Tensor) -> torch.Tensor:
    return (m.view(torch.int32) == 0).all(dim=1)


def _stop_emulated(llr, nbits, cadence: int, radix: int):
    """The fused kernels' stop rule on the plain sweep: (decisions,
    metrics, stop step per lane, full sweep's decisions and metrics). A
    lane stops at the first boundary b < Tp with b >= its bit count
    where the sweep over [0, b) leaves all metrics +0; its decisions are
    that sweep's, zero words after b, and its metrics +0."""
    B, Tp = llr.shape[0], llr.shape[1]
    dec_f, met_f, seen = _plain_sweep(llr, cadence, radix)
    nb = torch.as_tensor(nbits).long()
    stops = torch.full((B,), Tp)
    for b, m_b in seen[:-1]:
        stops[(stops == Tp) & (nb <= b) & _plus_zero(m_b)] = b
    dec, met = dec_f.clone(), met_f.clone()
    for f in range(B):
        if stops[f] < Tp:
            dec[f, stops[f]:] = 0
            met[f] = 0.0
    return dec, met, stops, dec_f, met_f


def _inputs(n_sym: int, ndbps, edge: int, seed: int):
    """Random symbols (FUSED_LANES, n_sym, 48, 2), live gains and bit
    counts, with chip_smoke.py's stop edge lanes around the boundary
    `edge`: lanes 0-16 ending 8 steps before to 8 after it, one of 0
    bits, two of at least Tp, one with an inf symbol before its bits
    end, one whose symbols past its bits are all NaN, and QUIET, whose
    first 4 symbols are 0, which (at BPSK) leaves its metrics all +0 at
    the first boundary, long before its bits end."""
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 0.7, (FUSED_LANES, n_sym, 48, 2)).astype(np.float32)
    gain = rng.uniform(0.2, 2.0, (FUSED_LANES, 48)).astype(np.float32)
    nbits = np.zeros(FUSED_LANES, np.int64)
    fused_edge_lanes(data, gain, nbits, ndbps, edge, n_sym * max(ndbps))
    return torch.from_numpy(data), torch.from_numpy(gain), nbits


def _check(llr, nbits, cadence, radix, dec_k, met_k, edge):
    """The emulated rule equals the full sweep (and the kernel's plain
    version, dec_k/met_k) bitwise, and stops each lane where it must."""
    dec, met, stops, dec_f, met_f = _stop_emulated(llr, nbits, cadence, radix)
    assert torch.equal(dec_f, dec_k)
    assert torch.equal(met_f.view(torch.int32), met_k.view(torch.int32))
    assert torch.equal(dec, dec_f)
    assert torch.equal(met.view(torch.int32), met_f.view(torch.int32))
    assert torch.equal(vc.traceback_plain(dec, met),
                       vc.traceback_plain(dec_f, met_f))
    tp = llr.shape[1]

    def need(n):
        return int(need_stop(n, cadence, tp))

    for i in range(EDGE_LANES):
        assert stops[i] == need(nbits[i]) == (edge if i <= 2 else
                                              edge + cadence), i
    assert stops[ZERO] == cadence
    assert stops[FULL] == stops[LONG] == tp
    assert stops[INF] == tp and torch.isnan(met_f[INF]).all()
    assert stops[NAN] == need(nbits[NAN]) < tp
    assert stops[QUIET] == need(nbits[QUIET])
    assert (stops % cadence == 0).all()


@pytest.mark.parametrize("radix", [2, 4])
def test_mixed_stop_rule_equals_full_sweep(radix):
    n_sym, cadence, edge = 8, vf.MIXED_UNROLL, 864         # Tp = 1728
    ridx = np.arange(FUSED_LANES) % 8
    ridx[QUIET] = 0                     # BPSK: zero symbols, +0 pairs
    ndbps = [params.RATES[params.RATE_MBPS_ORDER[r]].n_dbps for r in ridx]
    data, gain, nbits = _inputs(n_sym, ndbps, edge, seed=radix)
    llr = vf.fused_front_plain(data, gain, ridx, nbits, n_sym * 216)
    assert torch.isnan(data[NAN]).any() and not torch.isnan(llr[NAN]).any()
    dec_k, met_k = vf.fused_acs_mixed_plain(data, gain, ridx, nbits, radix)
    _check(llr, nbits, cadence, radix, dec_k, met_k, edge)
    assert _quiet_at_first_boundary(llr, cadence)


@pytest.mark.parametrize("radix", [2, 4])
def test_rate_stop_rule_equals_full_sweep(radix):
    # cadences 72, 96 and 216; Tp 864, 864 and 1728
    for mbps, n_sym, edge in ((6, 36, 432), (12, 18, 480), (54, 8, 864)):
        rate = params.RATES[mbps]
        cadence = vf.symbols_per_block(rate) * rate.n_dbps
        ndbps = [rate.n_dbps] * FUSED_LANES
        data, gain, nbits = _inputs(n_sym, ndbps, edge, seed=mbps + radix)
        ridx = [params.RATE_INDEX[mbps]] * len(ndbps)
        llr = vf.fused_front_plain(data, gain, ridx, nbits,
                                   n_sym * rate.n_dbps)
        dec_k, met_k = vf.fused_acs_rate_plain(data, gain, rate, nbits,
                                               radix)
        _check(llr, nbits, cadence, radix, dec_k, met_k, edge)
        assert _quiet_at_first_boundary(llr, cadence)


def _quiet_at_first_boundary(llr, cadence: int) -> bool:
    """Whether the QUIET lane's metrics are all +0 after the first renorm
    (its bit count lies far beyond): there only the bit count keeps the
    rule from stopping."""
    m = vc.acs_plain(llr[QUIET:QUIET + 1, :cadence], renorm=cadence)[1]
    return bool(_plus_zero(m)[0])


def _geometry_bits():
    """Each rate's bit count of a PSDU_BYTES frame: n_sym * n_dbps, as
    the receive paths hand it to the fused kernels."""
    return [params.n_symbols(PSDU_BYTES, params.RATES[m])
            * params.RATES[m].n_dbps for m in params.RATE_MBPS_ORDER]


@pytest.mark.parametrize("kernel", ["mixed", "rate"])
def test_stop_steps_at_chip_smoke_geometry(kernel):
    # random symbols at the bit counts of chip_smoke.py's frames, over a
    # trellis cut to a little past the last stop (the rule looks no
    # further than the stop)
    nbits = _geometry_bits()
    rng = np.random.default_rng(7)
    if kernel == "mixed":
        n_sym = 40                                      # Tp = 8640
        ridx = list(range(8))
        data = torch.from_numpy(
            rng.normal(0, 0.7, (8, n_sym, 48, 2)).astype(np.float32))
        gain = torch.from_numpy(rng.uniform(0.2, 2.0, (8, 48))
                                .astype(np.float32))
        llr = vf.fused_front_plain(data, gain, ridx, nbits, n_sym * 216)
        stops = _stop_emulated(llr, nbits, vf.MIXED_UNROLL, 2)[2]
        assert stops.tolist() == WANT_MIXED
        return
    got = []
    for m, nb in zip(params.RATE_MBPS_ORDER, nbits):
        rate = params.RATES[m]
        spb = vf.symbols_per_block(rate)
        cadence = spb * rate.n_dbps
        n_sym = int(need_stop(nb, cadence, 1 << 30)) // rate.n_dbps + spb
        data = torch.from_numpy(
            rng.normal(0, 0.7, (1, n_sym, 48, 2)).astype(np.float32))
        gain = torch.from_numpy(rng.uniform(0.2, 2.0, (1, 48))
                                .astype(np.float32))
        llr = vf.fused_front_plain(data, gain, [params.RATE_INDEX[m]], [nb],
                                   n_sym * rate.n_dbps)
        got.append(int(_stop_emulated(llr, [nb], cadence, 2)[2][0]))
    assert got == WANT_RATE
