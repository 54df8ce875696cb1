"""802.11a/g OFDM transmitter (counterpart of ziria_tpu/phy/wifi/tx.py):
crc >>> scramble >>> convolutional
encode + puncture >>> interleave >>> modulate >>> map subcarriers >>>
IFFT + CP, behind the preamble and the SIGNAL symbol.

``encode_frame`` is the per-frame entry. ``encode_many`` is the batched
TX: N frames of mixed rates and lengths at one padded (bit bucket,
symbol bucket) geometry, each rate's lanes encoded together where the
reference ran ``vmap(lax.switch)`` over the eight rates' encoders;
``encode_batch`` is its single-rate sibling. A lane's samples equal
``encode_frame``'s bit for bit whatever the batch (every stage is
per-position or per-symbol, and the DFT runs at fixed row blocks,
``cplx.DFT_BLOCK_ROWS``). ``tx_symbol_pipeline`` is the DATA symbols'
steady state as a stream program of ``core/ir`` stages, the CLI's
``wifi_tx_sym_*``."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ziria_tpu_torch.ops import coding, cplx, crc, interleave, modulate, \
    ofdm, scramble
from ziria_tpu_torch.ops.crc import append_crc32
from ziria_tpu_torch.phy.wifi.params import (N_SERVICE_BITS, N_TAIL_BITS,
                                             RATE_INDEX, RATE_MBPS_ORDER,
                                             RATES, RateParams, n_symbols)
from ziria_tpu_torch.utils import dispatch, geometry as _geometry
from ziria_tpu_torch.utils.bits import bytes_to_bits, uint_to_bits
from ziria_tpu_torch.utils.dispatch import pad_lanes

# the standard's example frame seed
DEFAULT_SCRAMBLER_SEED = 0b1011101


def _seed_bits_np(seed_val: int) -> np.ndarray:
    return np.array([(seed_val >> k) & 1 for k in range(7)], np.uint8)


def signal_field_bits(rate: RateParams, length_bytes,
                      device=None) -> torch.Tensor:
    """The 24-bit SIGNAL field: RATE(4) R1-first, reserved(1),
    LENGTH(12) LSB-first, even parity(1), tail(6). `length_bytes` an
    int (-> (24,)) or a (B,) tensor of lengths (-> (B, 24))."""
    length = uint_to_bits(length_bytes, 12, device=device)
    lead = length.shape[:-1]
    rate_bits = uint_to_bits(rate.signal_bits, 4, msb_first=True,
                             device=length.device).expand(lead + (4,))
    head = torch.cat([rate_bits, length.new_zeros(lead + (1,)), length], -1)
    parity = (head.to(torch.int64).sum(-1, keepdim=True) % 2).to(torch.uint8)
    return torch.cat([head, parity, length.new_zeros(lead + (6,))], -1)


def encode_signal_symbol(rate: RateParams, length_bytes,
                         device=None) -> torch.Tensor:
    """SIGNAL OFDM symbol (BPSK, rate 1/2, not scrambled): (80, 2), or
    (B, 80, 2) for a (B,) tensor of lengths."""
    coded = coding.conv_encode(signal_field_bits(rate, length_bytes,
                                                 device))
    syms = modulate.modulate(interleave.interleave(coded, 48, 1), 1)
    bins = ofdm.map_subcarriers(syms[..., None, :, :], symbol_index0=0)
    return ofdm.ofdm_modulate(bins)[..., 0, :, :]


def data_field_bits(psdu_bits: torch.Tensor, rate: RateParams,
                    n_sym: int) -> torch.Tensor:
    """SERVICE + PSDU + tail + pad, scrambled, tail re-zeroed after
    scrambling so the decoder ends in state 0."""
    dev = psdu_bits.device
    n_bits = n_sym * rate.n_dbps
    n_psdu = psdu_bits.shape[0]
    pad = n_bits - (N_SERVICE_BITS + n_psdu + N_TAIL_BITS)
    raw = torch.cat([
        torch.zeros(N_SERVICE_BITS, dtype=torch.uint8, device=dev),
        psdu_bits.to(torch.uint8),
        torch.zeros(N_TAIL_BITS + pad, dtype=torch.uint8, device=dev)])
    out = scramble.scramble_bits(raw, _seed_bits_np(DEFAULT_SCRAMBLER_SEED))
    tail_at = N_SERVICE_BITS + n_psdu
    out[tail_at: tail_at + N_TAIL_BITS] = 0
    return out


def encode_frame_bits(psdu_bits: torch.Tensor,
                      rate: RateParams) -> torch.Tensor:
    """PSDU bits -> frame samples (320 preamble + 80 SIGNAL +
    80*n_sym DATA, 2) float32, on the bits' device."""
    if psdu_bits.shape[0] % 8:
        raise ValueError(
            f"PSDU must be whole bytes; got {psdu_bits.shape[0]} bits")
    length_bytes = psdu_bits.shape[0] // 8
    n_sym = n_symbols(length_bytes, rate)
    bits = data_field_bits(psdu_bits, rate, n_sym)
    coded = coding.puncture(coding.conv_encode(bits), rate.coding)
    inter = interleave.interleave(coded, rate.n_cbps, rate.n_bpsc)
    syms = modulate.modulate(inter, rate.n_bpsc).reshape(n_sym, 48, 2)
    data_t = ofdm.ofdm_modulate(
        ofdm.map_subcarriers(syms, symbol_index0=1)).reshape(-1, 2)
    sig_t = encode_signal_symbol(rate, length_bytes, psdu_bits.device)
    return torch.cat([ofdm.preamble(psdu_bits.device), sig_t, data_t])


def encode_frame(psdu_bytes, rate_mbps: int, add_fcs: bool = False,
                 device="cuda") -> torch.Tensor:
    """Byte-level per-frame entry: PSDU bytes -> frame samples (n, 2)
    float32 on `device`. ``add_fcs`` appends the 32-bit CRC first."""
    data = torch.as_tensor(np.asarray(psdu_bytes, np.uint8), device=device)
    bits = bytes_to_bits(data)
    if add_fcs:
        bits = append_crc32(bits)
    with cplx.exact_fp32():
        return encode_frame_bits(bits, RATES[rate_mbps])


# ------------------------------------------------- bucketed / batched encode


def _sym_bucket(n_sym: int) -> int:
    """Power-of-two symbol bucket: the receiver's rule
    (``geometry.sym_bucket``), so a loopback's encode and decode
    geometries agree."""
    return _geometry.DEFAULT.sym_bucket(n_sym)


def _bit_bucket(n_bits: int) -> int:
    """Power-of-two PSDU bit bucket (floored, so tiny frames share
    one)."""
    return _geometry.DEFAULT.bit_bucket(n_bits)


def encode_frame_bits_bucketed(psdu_bits_padded, n_bits_real,
                               rate: RateParams,
                               n_sym_bucket: int) -> torch.Tensor:
    """A batch of PSDUs at one rate and a bucketed geometry -> frame
    samples padded to ``n_sym_bucket`` DATA symbols: psdu_bits_padded
    (B, bit_bucket) uint8, each PSDU zero-padded; n_bits_real (B,) their
    true bit counts (a tensor on the bits' device). Lane b's first
    400 + 80*n_symbols(real) samples equal ``encode_frame_bits``'s; the
    rest are pad symbols. The pad is free because every stage before
    the IFFT is per-position (scrambler, encoder, puncture) or
    per-symbol (interleave, modulate); only the 6 tail bits depend on
    the true length and are re-zeroed at each lane's own position."""
    bits_pad = psdu_bits_padded.to(torch.uint8)
    dev = bits_pad.device
    b = bits_pad.shape[0]
    n_bits = n_sym_bucket * rate.n_dbps
    room = n_bits - N_SERVICE_BITS
    if bits_pad.shape[1] >= room:
        body = bits_pad[:, :room]
    else:
        body = torch.nn.functional.pad(bits_pad,
                                       (0, room - bits_pad.shape[1]))
    raw = torch.nn.functional.pad(body, (N_SERVICE_BITS, 0))
    scrambled = scramble.scramble_bits(
        raw, _seed_bits_np(DEFAULT_SCRAMBLER_SEED))
    t = torch.arange(n_bits, device=dev)[None, :]
    tail_at = N_SERVICE_BITS + n_bits_real.to(torch.int64)[:, None]
    scrambled = torch.where((t >= tail_at) & (t < tail_at + N_TAIL_BITS),
                            0, scrambled).to(torch.uint8)
    coded = coding.puncture(coding.conv_encode(scrambled), rate.coding)
    inter = interleave.interleave(coded, rate.n_cbps, rate.n_bpsc)
    syms = modulate.modulate(inter, rate.n_bpsc).reshape(
        b, n_sym_bucket, 48, 2)
    data_t = ofdm.ofdm_modulate(
        ofdm.map_subcarriers(syms, symbol_index0=1)).reshape(b, -1, 2)
    sig_t = encode_signal_symbol(rate, n_bits_real.to(torch.int64) // 8,
                                 dev)
    pre = ofdm.preamble(dev).expand(b, -1, -1)
    return torch.cat([pre, sig_t, data_t], dim=1)


def encode_many_graph(bits_b, nbits_b, ridx_b,
                      n_sym_bucket: int) -> torch.Tensor:
    """The mixed-rate batch encode: bits_b (R, bit_bucket) zero-padded
    PSDU bits and nbits_b (R,) true bit counts on the device, ridx_b
    (R,) HOST ints indexing RATE_MBPS_ORDER. Each rate's lanes run that
    rate's bucketed encoder together (the reference selects the same
    values from all eight under ``vmap``); no host read. Returns (R,
    400 + 80*n_sym_bucket, 2)."""
    dev = bits_b.device
    ridx = np.asarray(ridx_b, np.int64)
    out = torch.empty((bits_b.shape[0], 400 + 80 * n_sym_bucket, 2),
                      dtype=torch.float32, device=dev)
    nbits = torch.as_tensor(nbits_b, dtype=torch.int64, device=dev)
    for r in np.unique(ridx):
        lanes = torch.from_numpy(np.flatnonzero(ridx == r)).to(dev)
        out[lanes] = encode_frame_bits_bucketed(
            bits_b[lanes], nbits[lanes], RATES[RATE_MBPS_ORDER[r]],
            n_sym_bucket)
    return out


def _host_psdu_bits(psdus: Sequence, add_fcs: bool) -> list:
    """PSDU bytes -> per-lane uint8 bits (FCS appended when asked), on
    the host: the lanes' bytes in one padded array, their FCS in one
    product (``crc._crc_bits``)."""
    lens = [len(p) for p in psdus]
    data = np.zeros((len(psdus), max(lens, default=0)), np.uint8)
    for i, p in enumerate(psdus):
        data[i, :lens[i]] = np.asarray(p, np.uint8)
    bits = bytes_to_bits(torch.from_numpy(data)).numpy()
    out = [bits[i, :8 * n] for i, n in enumerate(lens)]
    if not add_fcs:
        return out
    fcs = crc._crc_bits(torch.from_numpy(data), torch.tensor(
        lens, dtype=torch.int64)).numpy()
    return [np.concatenate([b, f]) for b, f in zip(out, fcs)]


class TxBatch(NamedTuple):
    """One encoded frame batch on the device. `samples` rows past the
    real lanes repeat lane 0 (the pad_lanes rule); lane i's frame is
    ``samples[i, :n_valid[i]]``, equal to ``encode_frame``'s."""
    samples: torch.Tensor         # (R_pow2, 400 + 80*n_sym_bucket, 2)
    n_valid: np.ndarray           # (B,) int32 valid sample counts
    n_sym: np.ndarray             # (B,) int32 true DATA symbol counts
    rates_mbps: tuple             # (B,) the lanes' rates
    n_sym_bucket: int


class TxHostPrep(NamedTuple):
    """The host-side batch prep every mixed-rate TX surface shares:
    ``encode_many`` consumes it and the loopback link's geometry wraps
    it, so the two cannot drift apart."""
    bits_list: list               # per-lane true PSDU(+FCS) bits
    n_sym: np.ndarray             # (B,) int32 true DATA symbol counts
    bit_bucket: int
    n_sym_bucket: int
    bits_b: np.ndarray            # (R_pow2, bit_bucket) padded rows
    nbits_b: np.ndarray           # (R_pow2,) int32 true bit counts
    ridx_b: np.ndarray            # (R_pow2,) int32 RATE_MBPS_ORDER idx


def batch_host_prep(psdus: Sequence, rates_mbps: Sequence[int],
                    add_fcs: bool = False) -> TxHostPrep:
    """Byte PSDUs -> the padded (bit bucket, symbol bucket) arrays of
    the mixed-rate encode: bits (FCS appended when asked), per-lane
    symbol counts, the common buckets, and rows by the pad_lanes rule
    (lane 0 repeated to the next power of two)."""
    if len(psdus) != len(rates_mbps):
        raise ValueError(f"{len(psdus)} PSDUs but {len(rates_mbps)} "
                         f"rates")
    if not len(psdus):
        raise ValueError("need at least one frame")
    bits_list = _host_psdu_bits(psdus, add_fcs)
    n_sym = np.asarray([n_symbols(b.shape[0] // 8, RATES[m])
                        for b, m in zip(bits_list, rates_mbps)], np.int32)
    bb = _bit_bucket(max(b.shape[0] for b in bits_list))
    sb = max(_sym_bucket(int(s)) for s in n_sym)
    lanes = pad_lanes(list(range(len(psdus))))
    bits_b = np.zeros((len(lanes), bb), np.uint8)
    nbits_b = np.zeros(len(lanes), np.int32)
    ridx_b = np.zeros(len(lanes), np.int32)
    for row, i in enumerate(lanes):
        bits_b[row, :bits_list[i].shape[0]] = bits_list[i]
        nbits_b[row] = bits_list[i].shape[0]
        ridx_b[row] = RATE_INDEX[rates_mbps[i]]
    return TxHostPrep(bits_list, n_sym, bb, sb, bits_b, nbits_b, ridx_b)


def encode_prep(prep: TxHostPrep, device) -> torch.Tensor:
    """The encode of a :class:`TxHostPrep` on `device`: (R_pow2, 400 +
    80*n_sym_bucket, 2)."""
    with cplx.exact_fp32(), dispatch.timed("tx.encode_many"):
        return encode_many_graph(
            torch.from_numpy(prep.bits_b).to(device),
            torch.from_numpy(prep.nbits_b.astype(np.int64)).to(device),
            prep.ridx_b, prep.n_sym_bucket)


def encode_many(psdus: Sequence, rates_mbps: Sequence[int],
                add_fcs: bool = False, device="cuda") -> TxBatch:
    """Mixed-rate, mixed-length TX: N PSDUs encoded at one padded (bit
    bucket, symbol bucket) geometry on `device`, one encode per rate
    present. Lane for lane equal to ``encode_frame``; the samples stay
    on the device for the channel and the receiver."""
    prep = batch_host_prep(psdus, rates_mbps, add_fcs)
    n_valid = (400 + 80 * prep.n_sym).astype(np.int32)
    return TxBatch(encode_prep(prep, device), n_valid, prep.n_sym,
                   tuple(rates_mbps), prep.n_sym_bucket)


def encode_batch(psdus, rate_mbps: int, add_fcs: bool = False,
                 device="cuda") -> torch.Tensor:
    """Single-rate, equal-length batch: (B, n_bytes) PSDUs -> (B,
    frame_len, 2) frames on `device`, sliced to the true frame length.
    Equal per lane to ``encode_frame`` (the TX of the BER sweep)."""
    psdus = np.asarray(psdus, np.uint8)
    bits = np.stack(_host_psdu_bits(psdus, add_fcs))
    n_frames, n_bits = bits.shape
    n_sym = n_symbols(n_bits // 8, RATES[rate_mbps])
    bits_b = np.zeros((n_frames, _bit_bucket(n_bits)), np.uint8)
    bits_b[:, :n_bits] = bits
    with cplx.exact_fp32(), dispatch.timed("tx.encode_batch"):
        out = encode_frame_bits_bucketed(
            torch.from_numpy(bits_b).to(device),
            torch.full((n_frames,), n_bits, dtype=torch.int64,
                       device=device),
            RATES[rate_mbps], _sym_bucket(n_sym))
    return out[:, :400 + 80 * n_sym]


def tx_symbol_pipeline(rate_mbps: int):
    """The DATA symbols' steady state as a stream program (reference
    :405): n_dbps raw bits in, 80 time samples out a firing, through
    three ``map_accum`` stages carrying the scrambler phase, the
    encoder's last 6 input bits and the pilot index. The stages run on
    the device of their input."""
    from ziria_tpu_torch.core import ir

    rate = RATES[rate_mbps]
    n_dbps, n_cbps, n_bpsc = rate.n_dbps, rate.n_cbps, rate.n_bpsc
    seq_np = scramble.np_lfsr_sequence_127(
        _seed_bits_np(DEFAULT_SCRAMBLER_SEED))
    pol_np = ofdm.PILOT_POLARITY.astype(np.float32)
    pilots_np = ofdm.PILOT_VALS.astype(np.float32)

    def stage_scramble(phase, bits):
        bits = torch.as_tensor(bits)
        dev = bits.device
        seq = torch.from_numpy(seq_np).to(dev)
        idx = (torch.as_tensor(phase, device=dev)
               + torch.arange(n_dbps, device=dev)) % 127
        return (phase + n_dbps) % 127, bits.to(torch.uint8) ^ seq[idx]

    def stage_encode(tail, bits):
        bits = torch.as_tensor(bits)
        ext = torch.cat([torch.as_tensor(tail, device=bits.device),
                         bits.to(torch.int32)])
        # from position 6 on no tap reaches the encoder's zero padding
        coded = coding.conv_encode(ext)[2 * (coding.K - 1):]
        return ext[-(coding.K - 1):], coding.puncture(coded, rate.coding)

    def stage_map(sym_idx, coded):
        coded = torch.as_tensor(coded)
        dev = coded.device
        syms = modulate.modulate(
            interleave.interleave(coded, n_cbps, n_bpsc), n_bpsc)
        pol = torch.from_numpy(pol_np).to(dev)[
            (torch.as_tensor(sym_idx, device=dev) + 1) % 127]
        bins = torch.zeros((ofdm.N_FFT, 2), dtype=torch.float32,
                           device=dev)
        bins[ofdm._index("data", dev)] = syms
        p_re = torch.from_numpy(pilots_np).to(dev) * pol
        bins[ofdm._index("pilot", dev)] = torch.stack(
            [p_re, torch.zeros_like(p_re)], dim=-1)
        return sym_idx + 1, ofdm.ofdm_modulate(bins[None])[0]

    return ir.pipe(
        ir.map_accum(stage_scramble, np.int32(0), in_arity=n_dbps,
                     out_arity=n_dbps, name="scramble"),
        ir.map_accum(stage_encode, np.zeros(6, np.int32), in_arity=n_dbps,
                     out_arity=n_cbps, name="encode"),
        ir.map_accum(stage_map, np.int32(0), in_arity=n_cbps,
                     out_arity=80, name="map_ofdm_ifft"),
    )
