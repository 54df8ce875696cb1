"""Fused demap front end + ACS on the card (counterpart of the fused
decodes of ziria_tpu/ops/viterbi_pallas.py: ``viterbi_decode_batch_fused``
:1023 and ``viterbi_decode_mixed_fused`` :1343).

Demap, deinterleave and depuncture are local to one OFDM symbol: a
symbol's n_cbps LLRs land in exactly that symbol's 2*n_dbps
depunctured slots. So one static table per rate, one row per slot,
describes the whole front end, and the decode kernel computes each LLR
from the equalized symbols when its ACS step needs it: the
(B, Tp, 2) LLR tensor never reaches device memory.

A table row is int32 (src, lev, amp, valid): the slot reads component
``src`` = 2c + comp of the symbol's flattened (48 subcarriers x I/Q)
vector and the gain of subcarrier c = src >> 1, applies level formula
``lev`` (0: x; 1: amp - |x|; 2: 2 - ||x| - 4|) with level-1 amplitude
``amp``; ``valid`` is 0 for a punctured slot, an erasure. The Pallas
kernels hold the same facts as one-hot matrices for the MXU;
``tables.reference_tables`` expands these rows to that form, and the
tests pin them equal.

Two kernels share one device routine (csrc/viterbi.cu
``fused_acs_block<Radix>``), each with a wrapper, a plain version and a
launch count per radix (radix 4 takes two ACS steps as one butterfly,
bit-identical to radix 2; the sub-block's 12 steps are six whole
pairs):

- :func:`fused_acs_mixed` runs ``fused_acs_mixed_kernel<R>`` (keys
  ``fused_mixed``, ``fused_mixed_r4``), replacing
  ``_make_mixed_fused_acs_kernel(n_sym_p, R)`` (viterbi_pallas.py:1174):
  each frame at its own rate over the bucket-maximal trellis n_sym *
  216, renorm every 72 steps (``MIXED_UNROLL``), symbol reads clamped
  to the last symbol.
- :func:`fused_acs_rate` runs ``fused_acs_rate_kernel<R>`` (keys
  ``fused_rate``, ``fused_rate_r4``), replacing
  ``_make_fused_acs_kernel(spb, n_dbps, norm, R)`` (viterbi_pallas.py:893):
  one rate for the batch, symbols padded to a multiple of spb =
  ceil(64 / n_dbps), renorm every spb * n_dbps steps (72, 72, 96, 72,
  96, 144, 192, 216 for the 8 rates).

Both write ``viterbi_cuda.acs``'s decisions and final metrics, so
``viterbi_cuda.traceback`` finishes either decode: the Pallas
traceback instances at :1006 and :1326 walk the same words.
``fused_acs_mixed_with_stops`` and ``fused_acs_rate_with_stops`` also
return the step at which each frame's sweep ended.

Bits: under erasure tails path metrics tie exactly, so the renorm
cadence and the arithmetic order decide bits. Kernel and plain version
compute ``x * norm``, the level formula, ``(f * g) * valid`` and the
exact 0 past each frame's bit count in that order, then the ACS of
``viterbi_cuda``. On the card, what bounds them is the ACS chain
(see csrc/viterbi.cu). Every pair at or past a frame's bit count is a
literal +0, so the kernels stop each chain, exactly, at the first
renorm at or past the bit count that leaves all 64 metrics +0 (the full
sweep writes only zero words and +0 metrics from there) and write the
zero words themselves; three more warps compute each renorm stage's
pairs one stage ahead, off the chain. The plain versions sweep every
step: they are the yardstick the kernels are held to.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ziria_tpu_torch.ops import viterbi_cuda
from ziria_tpu_torch.ops.coding import PUNCTURE_KEEP
from ziria_tpu_torch.ops.demap import _NORM, demap_bit_layout
from ziria_tpu_torch.ops.interleave import deinterleave_slots
from ziria_tpu_torch.ops.viterbi import _check_radix
from ziria_tpu_torch.phy.wifi.params import MAX_DBPS, RATE_INDEX, \
    RATE_MBPS_ORDER, RATES, RateParams

#: trellis steps per front sub-block: the gcd of all 8 rates' n_dbps
MIXED_SUB = 12
#: renorm cadence of the mixed decode (6 sub-blocks; 72 divides 216)
MIXED_UNROLL = 72
#: 24-slot chunks per rate row of the bank: max n_dbps / MIXED_SUB
MIXED_CHUNKS = 18

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"fused_mixed": 0, "fused_rate": 0, "fused_mixed_r4": 0,
            "fused_rate_r4": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------- tables


@lru_cache(maxsize=None)
def _mixed_rate_geometry():
    """(n_dbps, norm) per rate in RATE_MBPS_ORDER."""
    ndbps = tuple(RATES[m].n_dbps for m in RATE_MBPS_ORDER)
    norms = tuple(float(_NORM[RATES[m].n_bpsc]) for m in RATE_MBPS_ORDER)
    return ndbps, norms


@lru_cache(maxsize=None)
def front_tables(n_bpsc: int, n_cbps: int, n_dbps: int,
                 coding: str) -> np.ndarray:
    """(2 * n_dbps, 4) int32 slot table of one symbol at one rate: row p
    is (src, lev, amp, valid) of depunctured slot p; punctured slots
    are all zero. Built from the same primitives as the unfused front
    (``demap_bit_layout``, ``deinterleave_slots``, ``PUNCTURE_KEEP``)."""
    keep = PUNCTURE_KEEP[coding]
    period, kept = keep.size, int(keep.sum())
    sub, bit = deinterleave_slots(n_cbps, n_bpsc)
    comp, lev, amp = demap_bit_layout(n_bpsc)
    nkeep_before = np.cumsum(keep) - keep
    tab = np.zeros((2 * n_dbps, 4), np.int32)
    for p in range(2 * n_dbps):
        blk, off = divmod(p, period)
        if not keep[off]:
            continue
        q = blk * kept + int(nkeep_before[off])
        c, b = int(sub[q]), int(bit[q])
        tab[p] = (2 * c + int(comp[b]), int(lev[b]), int(amp[b]), 1)
    return tab


@lru_cache(maxsize=None)
def mixed_front_tables() -> np.ndarray:
    """The 8 rates' slot tables stacked: (8, MIXED_CHUNKS, 24, 4) int32,
    row r = rate RATE_MBPS_ORDER[r], chunk c = slots [24c, 24c + 24) of
    its :func:`front_tables`; chunks past n_dbps[r] / 12 stay zero."""
    bank = np.zeros((8, MIXED_CHUNKS, 2 * MIXED_SUB, 4), np.int32)
    for r, m in enumerate(RATE_MBPS_ORDER):
        p = RATES[m]
        tab = front_tables(p.n_bpsc, p.n_cbps, p.n_dbps, p.coding)
        bank[r].reshape(-1, 4)[:tab.shape[0]] = tab
    return bank


@lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """(bank (8, 432, 4) int32, ndbps (8,) int32, norms (8,) float32) on
    `device`, built once."""
    ndbps, norms = _mixed_rate_geometry()
    bank = torch.from_numpy(mixed_front_tables().reshape(8, -1, 4))
    return (bank.to(device).contiguous(),
            torch.tensor(ndbps, dtype=torch.int32, device=device),
            torch.tensor(norms, dtype=torch.float32, device=device))


# ---------------------------------------------------------------- front


def _symbols(data: torch.Tensor) -> torch.Tensor:
    """(B, n_sym, 48, 2) or (B, n_sym, 96) -> contiguous (B, n_sym, 96)
    float32, component 2c + I/Q."""
    if data.dim() not in (3, 4) or data.shape[2:] not in ((48, 2), (96,)):
        raise ValueError(f"fused front: want (B, n_sym, 48, 2) symbols, "
                         f"got {tuple(data.shape)}")
    return data.to(torch.float32).reshape(
        data.shape[0], data.shape[1], 96).contiguous()


def _rate_rows(rate_idx, B: int) -> np.ndarray:
    """Host rate indices (B,), checked to lie in [0, 8)."""
    r = np.broadcast_to(np.asarray(rate_idx, np.int64), (B,))
    if r.size and (r.min() < 0 or r.max() >= len(RATE_MBPS_ORDER)):
        raise ValueError(f"rate_idx outside [0, 8): {r}")
    return r


def fused_front_plain(data, gain, rate_idx, nbits, Tp: int) -> torch.Tensor:
    """The table-driven fused front in plain tensor ops: equalized
    symbols (B, n_sym, 48, 2), gains (B, 48), host rate indices (B,)
    into RATE_MBPS_ORDER (each lane's n_dbps and norm follow from
    them), bit counts (B,) -> depunctured soft pairs (B, Tp, 2). Step s
    of a lane reads symbol min(s // n_dbps, n_sym - 1); every step at
    or past its lane's bit count is an exact 0. The kernels' arithmetic,
    operation for operation."""
    x = _symbols(data)
    B, n_sym = x.shape[0], x.shape[1]
    dev = x.device
    bank, ndbps_t, norms_t = _device_tables(dev)
    ridx = torch.from_numpy(_rate_rows(rate_idx, B).copy()).to(dev)
    ndb = ndbps_t.long()[ridx][:, None]                      # (B, 1)
    nb = torch.as_tensor(nbits, device=dev).long().reshape(-1)
    nb = nb.expand(B)[:, None, None]
    s = torch.arange(Tp, device=dev)[None, :]                # (1, Tp)
    k = torch.clamp(s // ndb, max=n_sym - 1)                 # (B, Tp)
    p = (2 * (s % ndb))[..., None] + torch.arange(2, device=dev)
    ent = bank.long()[ridx[:, None, None], p]                # (B, Tp, 2, 4)
    src, lev = ent[..., 0], ent[..., 1]
    amp, valid = ent[..., 2].float(), ent[..., 3].float()
    xv = torch.gather(x.reshape(B, -1), 1,
                      (k[..., None] * 96 + src).reshape(B, -1))
    g = torch.gather(gain.to(torch.float32), 1, (src >> 1).reshape(B, -1))
    xs = xv.reshape(B, Tp, 2) * norms_t[ridx][:, None, None]
    ax = xs.abs()
    f = torch.where(lev == 0, xs,
                    torch.where(lev == 1, amp - ax,
                                2.0 - (ax - 4.0).abs()))
    llr = (f * g.reshape(B, Tp, 2)) * valid
    return torch.where(s[..., None] < nb, llr, 0.0)


# --------------------------------------------------------- mixed kernel


def _key(name: str, radix: int) -> str:
    if radix not in (2, 4):
        raise ValueError(f"{name}: radix {radix!r} is not 2 or 4")
    return name if radix == 2 else f"{name}_r4"


def fused_acs_mixed_plain(data, gain, rate_idx, nbits, radix: int = 2):
    """:func:`fused_acs_mixed` in plain PyTorch: the fused front, then
    the ACS at `radix` renormalizing every 72 steps."""
    Tp = data.shape[1] * MAX_DBPS
    return viterbi_cuda.acs_plain(
        fused_front_plain(data, gain, rate_idx, nbits, Tp),
        renorm=MIXED_UNROLL, radix=radix)


def fused_acs_mixed(data, gain, rate_idx, nbits, radix: int = 2):
    """Rate-switched fused front + ACS: symbols (B, n_sym, 48, 2), gains
    (B, 48), host rate indices (B,) into RATE_MBPS_ORDER, bit counts
    (B,) -> (decisions (B, Tp, 8) uint8, final metrics (B, 64)), Tp =
    n_sym * 216, at radix 2 or 4. Launches ``fused_acs_mixed_kernel``
    on CUDA tensors (one block per frame; the sweep stops, exactly,
    after the first renorm at or past the frame's bit count that leaves
    every metric +0), runs :func:`fused_acs_mixed_plain` on CPU ones."""
    return _fused_mixed(data, gain, rate_idx, nbits, radix, False)[:2]


def fused_acs_mixed_with_stops(data, gain, rate_idx, nbits,
                               radix: int = 2):
    """:func:`fused_acs_mixed`, and (B,) int32 the step at which each
    frame's sweep ended: a multiple of 72, Tp for a full sweep (always,
    for the plain version)."""
    return _fused_mixed(data, gain, rate_idx, nbits, radix, True)


def _full_sweep(B: int, Tp: int) -> torch.Tensor:
    """The plain versions' stop steps: every frame swept to Tp."""
    return torch.full((B,), Tp, dtype=torch.int32)


def _fused_mixed(data, gain, rate_idx, nbits, radix: int, want_stops: bool):
    key = _key("fused_mixed", radix)
    x = _symbols(data)
    B, n_sym = x.shape[0], x.shape[1]
    Tp = n_sym * MAX_DBPS
    ridx = _rate_rows(rate_idx, B)
    if x.device.type == "cpu":
        return (*fused_acs_mixed_plain(x, gain, ridx, nbits, radix),
                _full_sweep(B, Tp) if want_stops else None)
    viterbi_cuda._check_cuda("fused_acs_mixed", x)
    g, nb = _gain_and_bits(x, gain, nbits, B)
    if B == 0:
        raise ValueError("fused_acs_mixed: empty batch")
    dev = x.device
    bank, ndbps_t, norms_t = _device_tables(dev)
    r = torch.from_numpy(ridx.astype(np.int32)).to(dev, non_blocking=True)
    dec = torch.empty((B, Tp, 8), dtype=torch.uint8, device=dev)
    metrics = torch.empty((B, 64), dtype=torch.float32, device=dev)
    stops = (torch.empty((B,), dtype=torch.int32, device=dev)
             if want_stops else None)
    err = viterbi_cuda._lib().ziria_fused_acs_mixed(
        x.data_ptr(), g.data_ptr(), nb.data_ptr(), r.data_ptr(),
        bank.data_ptr(), ndbps_t.data_ptr(), norms_t.data_ptr(),
        dec.data_ptr(), metrics.data_ptr(),
        None if stops is None else stops.data_ptr(), B, n_sym, Tp, radix,
        dev.index, viterbi_cuda._stream(x))
    viterbi_cuda._raise_on(err, f"fused_acs_mixed_kernel ({key})")
    LAUNCHES[key] += 1
    return dec, metrics, stops


def _gain_and_bits(x, gain, nbits, B: int):
    """Contiguous float32 gains (B, 48) and int32 bit counts (B,) on
    the symbols' device. Host bit counts (and the wrappers' host rate
    indices) go over without a stream sync: a copy from pageable memory
    is staged before it returns, and a sync would leave the card idle
    while the host prepares the next launch."""
    g = gain.to(device=x.device, dtype=torch.float32).contiguous()
    if g.shape != (B, 48):
        raise ValueError(f"fused: want ({B}, 48) gains, got "
                         f"{tuple(g.shape)}")
    nb = torch.as_tensor(nbits).to(x.device, torch.int32, non_blocking=True)
    return g, nb.reshape(-1).expand(B).contiguous()


def viterbi_decode_mixed_fused(data, gain, rate_idx, nbits_real,
                               radix: int = None):
    """Rate-switched fused decode of a mixed-rate batch: -> (B, n_sym *
    216) raw decoded bits, the shape and meaning of the unfused mixed
    trellis (valid over each lane's first nbits_real bits). ``radix``
    None reads ZIRIA_VITERBI_RADIX."""
    return viterbi_cuda.traceback(*fused_acs_mixed(
        data, gain, rate_idx, nbits_real, _check_radix(radix)))


# ---------------------------------------------------- known-rate kernel


def symbols_per_block(rate: RateParams) -> int:
    """spb: the fewest symbols whose steps reach one 64-step ACS block;
    the known-rate decode renormalizes every spb * n_dbps steps."""
    return -(-viterbi_cuda.RENORM // rate.n_dbps)


def _rate_table(rate: RateParams, device):
    """Rate `rate`'s slot table: its row of the device bank."""
    bank, _ndbps, _norms = _device_tables(torch.device(device))
    return bank[RATE_INDEX[rate.mbps]]


def fused_acs_rate_plain(data, gain, rate: RateParams, nbits,
                         radix: int = 2):
    """:func:`fused_acs_rate` in plain PyTorch."""
    Tp = data.shape[1] * rate.n_dbps
    ridx = [RATE_INDEX[rate.mbps]] * data.shape[0]
    return viterbi_cuda.acs_plain(
        fused_front_plain(data, gain, ridx, nbits, Tp),
        renorm=symbols_per_block(rate) * rate.n_dbps, radix=radix)


def fused_acs_rate(data, gain, rate: RateParams, nbits, radix: int = 2):
    """Known-rate fused front + ACS: symbols (B, n_sym, 48, 2) with
    n_sym a multiple of :func:`symbols_per_block`, gains (B, 48), bit
    counts (B,) -> (decisions (B, Tp, 8) uint8, final metrics (B, 64)),
    Tp = n_sym * n_dbps, at radix 2 or 4. Launches
    ``fused_acs_rate_kernel`` on CUDA tensors (stopping as
    :func:`fused_acs_mixed` does, at its own cadence), runs
    :func:`fused_acs_rate_plain` on CPU ones."""
    return _fused_rate(data, gain, rate, nbits, radix, False)[:2]


def fused_acs_rate_with_stops(data, gain, rate: RateParams, nbits,
                              radix: int = 2):
    """:func:`fused_acs_rate`, and (B,) int32 the step at which each
    frame's sweep ended: a multiple of spb * n_dbps, Tp for a full sweep
    (always, for the plain version)."""
    return _fused_rate(data, gain, rate, nbits, radix, True)


def _fused_rate(data, gain, rate: RateParams, nbits, radix: int,
                want_stops: bool):
    key = _key("fused_rate", radix)
    x = _symbols(data)
    B, n_sym = x.shape[0], x.shape[1]
    spb = symbols_per_block(rate)
    if n_sym % spb:
        raise ValueError(f"fused_acs_rate: n_sym={n_sym} is not a multiple "
                         f"of spb={spb} at {rate.mbps} Mbps")
    Tp = n_sym * rate.n_dbps
    if x.device.type == "cpu":
        return (*fused_acs_rate_plain(x, gain, rate, nbits, radix),
                _full_sweep(B, Tp) if want_stops else None)
    viterbi_cuda._check_cuda("fused_acs_rate", x)
    g, nb = _gain_and_bits(x, gain, nbits, B)
    if B == 0:
        raise ValueError("fused_acs_rate: empty batch")
    dev = x.device
    table = _rate_table(rate, dev)
    dec = torch.empty((B, Tp, 8), dtype=torch.uint8, device=dev)
    metrics = torch.empty((B, 64), dtype=torch.float32, device=dev)
    stops = (torch.empty((B,), dtype=torch.int32, device=dev)
             if want_stops else None)
    err = viterbi_cuda._lib().ziria_fused_acs_rate(
        x.data_ptr(), g.data_ptr(), nb.data_ptr(), table.data_ptr(),
        dec.data_ptr(), metrics.data_ptr(),
        None if stops is None else stops.data_ptr(), rate.n_dbps,
        float(np.float32(_NORM[rate.n_bpsc])), B, n_sym, Tp,
        spb * rate.n_dbps, radix, dev.index, viterbi_cuda._stream(x))
    viterbi_cuda._raise_on(err, f"fused_acs_rate_kernel ({key})")
    LAUNCHES[key] += 1
    return dec, metrics, stops


def pad_symbols(data, rate: RateParams) -> torch.Tensor:
    """Symbols (B, n_sym, 48, 2) -> (B, n_sym_p, 96), zero-padded to a
    multiple n_sym_p of spb, the shape :func:`fused_acs_rate` takes."""
    x = _symbols(data)
    spb = symbols_per_block(rate)
    n_sym_p = -(-x.shape[1] // spb) * spb
    if n_sym_p == x.shape[1]:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, n_sym_p - x.shape[1]))


def viterbi_decode_batch_fused(data, gain, rate: RateParams,
                               n_bits: int = None, nbits_real=None,
                               radix: int = None):
    """Known-rate fused decode: equalized symbols (B, n_sym, 48, 2) and
    gains (B, 48) at one rate -> (B, n_sym * n_dbps) bits (or the first
    `n_bits`). Symbols are zero-padded to a multiple of spb, whose
    steps lie past every lane's bit count; nbits_real (B,) defaults to
    every step real. ``radix`` None reads ZIRIA_VITERBI_RADIX."""
    radix = _check_radix(radix)
    T = data.shape[1] * rate.n_dbps
    nbits = T if nbits_real is None else nbits_real
    bits = viterbi_cuda.traceback(*fused_acs_rate(
        pad_symbols(data, rate), gain, rate, nbits, radix))
    return bits[:, :T if n_bits is None else min(T, n_bits)]
