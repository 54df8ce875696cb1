"""Fixed-point (Q15/complex16-style) 802.11a DATA decode interior
(counterpart of ziria_tpu/phy/wifi/rx_fxp.py).

The reference RX ran its whole steady-state chain in int16 fixed point
(SORA bricks, SURVEY.md §2.2-2.3); the main RX interior is float32.
This module is the division-free integer decode path whose every op is
exact int32 arithmetic, so its output is **bit-identical across
devices, batch widths and packages** for identical quantized input.
The input of ``rx.receive(fxp=True)`` is not identical between the
packages: it comes from float32 acquisition, whose sums and
transcendentals round differently, so that receive is held to the
reference field for field, with a bound on its Q11 difference, not
bit for bit.

- the aligned, CFO-corrected frame is quantized to Q11 int16 IQ
  (`quantize_frame`), the fixed-point boundary;
- the 64-pt FFT is `ops/fxp.dft64_q14`, a product against split Q14
  twiddles;
- **no zero-forcing division**: instead of eq = y / H it carries
  z = y * conj(H) and demaps against thresholds scaled by G = |H|^2;
- pilot common-phase tracking is integer CORDIC: vectoring recovers
  the pilot phase, rotation derotates the data bins (the pilot sum
  weights each pilot by its subcarrier gain G_k, as the reference's
  does);
- LLRs leave as int16; the Viterbi on exact small integers in float32
  is itself exact, so the decoded bits, and therefore descramble and
  CRC, inherit bit-exactness end to end.

Frames are (L, 2) or a batch (B, L, 2), the batch axis first. The
per-frame decodes use the scan decoder, as the reference's do; the
batched :func:`decode_data_batch_fxp` runs the ACS and traceback
kernels (or the windowed decode) of ops/viterbi_cuda.
"""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.ops import coding, fxp, interleave, ofdm, scramble, \
    viterbi, viterbi_cuda
from ziria_tpu_torch.ops.demap import _NORM as _NORM_F
from ziria_tpu_torch.phy.wifi.params import N_SERVICE_BITS, RateParams
from ziria_tpu_torch.phy.wifi.rx import FRAME_DATA_START
from ziria_tpu_torch.utils import telemetry

Q_IN = 11              # input quantization: Q11 (4 bits of PAPR headroom)
_DFT_SHIFT = 10        # dft64_q14 shift: bins ~= DFT * 2^-3 of Q11 input
_Z_SHIFT = 4           # pre-add shift inside y*conj(H) and |H|^2
_W_SHIFT = 3           # working shift down to demap precision
# overflow audit (Q11 input, |H| <= 4, 64-QAM corners): bins <= 2^16,
# z products <= 2^27, zw <= 2^20.5, zw * NORM_Q7 <= 2^30.2: all int32
LLR_SHIFT = 5          # int32 LLR -> int16 output scale

# level-domain norm constants in Q7, derived from the float demapper's
# table so the two cannot drift
_NORM_Q7 = {k: int(round(v * 128)) for k, v in _NORM_F.items()}

# the LTS reference (+-1 on the used bins), pilot polarity and values as
# integers
_LTS_REF = np.zeros(ofdm.N_FFT, np.int32)
_LTS_REF[(np.arange(-26, 27) % ofdm.N_FFT)] = ofdm.LTS_FREQ.astype(np.int32)
_POLARITY = np.rint(ofdm.PILOT_POLARITY).astype(np.int32)
_PILOT_VALS = np.rint(ofdm.PILOT_VALS).astype(np.int32)


def _tab(name: str, arr: np.ndarray, device) -> torch.Tensor:
    return fxp._const(("rx_fxp", name), device,
                      lambda d: torch.from_numpy(arr).to(d))


def quantize_frame(frame_f32):
    """Float aligned frame (..., 2) -> int32-held Q11 int16 samples."""
    return fxp.quantize_q(frame_f32, Q_IN)


def _fft_bins(sym_pairs):
    """(..., 80, 2) int Q11 time samples -> (..., 64, 2) int bins
    (CP stripped; unnormalized DFT scaled 2^-3)."""
    return fxp.dft64_q14(sym_pairs[..., ofdm.N_CP:, :], shift=_DFT_SHIFT)


def _estimate_channel_q(frame_q):
    """Integer channel estimate from the two LTS symbols of (..., L, 2)
    frames: bin average times the known +-1 reference, at the same
    scale as the data bins. (..., 64, 2)."""
    frame_q = fxp._i32(frame_q)
    l1 = fxp.dft64_q14(frame_q[..., 192:256, :], shift=_DFT_SHIFT)
    l2 = fxp.dft64_q14(frame_q[..., 256:320, :], shift=_DFT_SHIFT)
    avg = fxp.rsra(l1 + l2, 1)
    return avg * _tab("lts", _LTS_REF, frame_q.device)[:, None]


def _demap_q(i_lvl, gw, n_bpsc: int):
    """Level-domain max-log LLRs, all-integer: i_lvl ~ lvl * Gw where
    Gw is the per-subcarrier gain; thresholds are multiples of Gw
    (demap.py level formulas with |H|^2 folded through)."""
    if n_bpsc in (1, 2):
        return i_lvl[..., None] if n_bpsc == 1 else i_lvl
    a = i_lvl.abs()
    if n_bpsc == 4:
        return torch.stack([i_lvl, 2 * gw - a], dim=-1)
    return torch.stack([i_lvl, 4 * gw - a,
                        2 * gw - (a - 4 * gw).abs()], dim=-1)


def _front_batch(frames_q, rate: RateParams, n_sym: int):
    """(B, L, 2) quantized aligned frames -> depunctured int32 LLR
    pairs (B, T, 2): channel estimate, integer DFT, conj-multiply
    'equalize', CORDIC pilot derotation, gain-scaled demap,
    deinterleave, depuncture."""
    frames_q = fxp._i32(frames_q)
    B, dev = frames_q.shape[0], frames_q.device
    H = _estimate_channel_q(frames_q)                      # (B, 64, 2)
    syms = frames_q[:, FRAME_DATA_START: FRAME_DATA_START + 80 * n_sym]
    bins = _fft_bins(syms.reshape(B, n_sym, 80, 2))        # (B, n_sym, 64, 2)

    # division-free equalize: z = y * conj(H), gain G = |H|^2, both at
    # working precision
    z = fxp.cmul_conj_i32(bins, H[:, None], _Z_SHIFT)
    zw = fxp.rsra(z, _W_SHIFT)
    gw = fxp.rsra(fxp.cabs2_i32(H, _Z_SHIFT), _W_SHIFT)    # (B, 64)

    data = zw[:, :, _tab("data", ofdm.DATA_BINS.astype(np.int64), dev)]
    pilots = zw[:, :, _tab("pilot", ofdm.PILOT_BINS.astype(np.int64), dev)]
    g_data = gw[:, _tab("data", ofdm.DATA_BINS.astype(np.int64), dev)]

    # pilot common phase, symbol polarity applied; CORDIC vectoring
    # (z already carries G_k per pilot: a gain-weighted pilot sum)
    pol = _tab("polarity", _POLARITY, dev)[
        (torch.arange(n_sym, device=dev) + 1) % 127]
    w = pol[:, None] * _tab("pilot_vals", _PILOT_VALS, dev)[None, :]
    p = (pilots * w[..., None]).sum(dim=-2, dtype=torch.int32)
    ang, _mag = fxp.cordic_atan2(p[..., 1], p[..., 0])     # (B, n_sym)

    # derotate every data bin by -phase (kinv_bits=10: zw reaches
    # ~2^20.5 at |H|=4, above the Q15-compensation input limit)
    data = fxp.cordic_rotate(data, -ang[..., None], kinv_bits=10)

    # level scale: i_lvl ~= lvl * Gw via the Q7 norm constant
    cn = _NORM_Q7[rate.n_bpsc]
    i_lvl = fxp.rsra(data[..., 0] * cn, 7)
    q_lvl = fxp.rsra(data[..., 1] * cn, 7)
    gvec = g_data[:, None, :].expand(i_lvl.shape)
    if rate.n_bpsc == 1:
        llr = _demap_q(i_lvl, gvec, 1)
    else:
        half = rate.n_bpsc // 2
        llr = torch.cat(
            [_demap_q(i_lvl, gvec, rate.n_bpsc).reshape(
                i_lvl.shape + (half,)),
             _demap_q(q_lvl, gvec, rate.n_bpsc).reshape(
                 q_lvl.shape + (half,))], dim=-1)
    llr16 = fxp.sat16(fxp.rsra(llr.reshape(B, n_sym, -1), LLR_SHIFT))

    deint = interleave.deinterleave(llr16.reshape(B, -1), rate.n_cbps,
                                    rate.n_bpsc)
    return coding.depuncture(deint, rate.coding, fill=0).reshape(B, -1, 2)


def decode_front_fxp(frame_q, rate: RateParams, n_sym: int):
    """Quantized aligned frame (L, 2), or a batch (B, L, 2) ->
    depunctured int32-held int16 LLR pairs (T, 2) (or (B, T, 2)): the
    integer mirror of rx._decode_front."""
    frame_q = fxp._i32(frame_q)
    if frame_q.dim() == 2:
        return _front_batch(frame_q[None], rate, n_sym)[0]
    return _front_batch(frame_q, rate, n_sym)


def _descramble(bits):
    """(B, n) decoded bits -> (B, n) descrambled bits."""
    return scramble.descramble_bits(bits, scramble.recover_seed(bits[:, :7]))


def decode_data_fxp(frame_q, rate: RateParams, n_sym: int,
                    n_psdu_bits: int):
    """Quantized aligned frame -> (psdu_bits, service_bits): all-integer
    front end, then the exact-integer-in-float32 scan Viterbi and
    descramble."""
    dep = decode_front_fxp(frame_q, rate, n_sym)
    bits = viterbi.viterbi_decode(dep[None].to(torch.float32),
                                  n_bits=n_sym * rate.n_dbps)
    clear = _descramble(bits)[0]
    return (clear[N_SERVICE_BITS: N_SERVICE_BITS + n_psdu_bits],
            clear[:N_SERVICE_BITS])


def decode_data_bucketed_fxp(frame_q, rate: RateParams,
                             n_sym_bucket: int, n_bits_real):
    """Bucketed fixed-point DATA decode (rx.decode_data_bucketed's
    integer twin): `frame_q` is quantized and padded to
    FRAME_DATA_START + 80*n_sym_bucket samples, `n_bits_real` the true
    data-bit count. LLR rows at or beyond n_bits_real are zeroed (0 is
    an exact erasure in integer land too), so the pad adds no
    likelihood. Returns the full descrambled stream; the caller slices
    the PSDU."""
    dep = decode_front_fxp(frame_q, rate, n_sym_bucket)
    t = torch.arange(dep.shape[0], device=dep.device)
    dep = torch.where((t < n_bits_real)[:, None], dep,
                      torch.zeros_like(dep))
    bits = viterbi.viterbi_decode(dep[None].to(torch.float32),
                                  n_bits=n_sym_bucket * rate.n_dbps)
    return _descramble(bits)[0]


def decode_data_batch_fxp(frames_q, rate: RateParams, n_sym: int,
                          n_psdu_bits: int, viterbi_window: int = None):
    """Batched integer decode: (B, frame_len, 2) int -> ((B, n), (B, 16)),
    the same lane layout as rx.decode_data_batch: the integer front over
    the batch, then the batch Viterbi of ops/viterbi_cuda (the ACS and
    traceback kernels on a CUDA tensor, their plain versions on a CPU
    one) on the integer-valued float32 LLRs.

    ``viterbi_window`` opts into the sliding-window decode, exactly as
    on the float path; the integer LLRs reaching the kernel are
    unchanged, so bit-identity across devices holds per window too."""
    with telemetry.span("rx_fxp.front"):
        dep = _front_batch(frames_q, rate, n_sym)
    with telemetry.span("rx_fxp.decode"):
        bits = viterbi_cuda.viterbi_decode_batch_opt(
            dep.to(torch.float32), n_bits=n_sym * rate.n_dbps,
            window=viterbi_window)
        clear = _descramble(bits)
    return (clear[:, N_SERVICE_BITS: N_SERVICE_BITS + n_psdu_bits],
            clear[:, :N_SERVICE_BITS])
