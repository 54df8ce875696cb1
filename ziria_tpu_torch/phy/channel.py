"""Channel impairment models for loopback testing (counterpart of
ziria_tpu/phy/channel.py): AWGN, carrier frequency offset, integer
delay, phase offset, multipath FIR, sampling-clock offset, oscillator
drift and interference bursts, on (..., 2) float32 pair samples.

Every draw is the reference's own: keys come from one seed by the
reference's fold-in schedule (:func:`lane_key`, the burst salts) and
``utils/threefry`` computes ``jax.random``'s words from them, so lane i
carries the reference's noise field whatever the batch, on any device.
A lane's samples depend only on (seed, lane) and its own parameters:
every reduction over a lane (the signal power) is a pairwise sum at a
fixed power-of-two shape (:func:`_lane_sum`), so row i of
:func:`impair_many` equals :func:`impair_one` at ``lane=i`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.ops import cplx
from ziria_tpu_torch.phy import profiles as chanprof
from ziria_tpu_torch.utils import dispatch, threefry
from ziria_tpu_torch.utils.dispatch import pow2_ceil

# salts folding the lane key into independent draw streams: the AWGN
# takes the bare lane key (so the profiled and unprofiled channels draw
# the same noise), bursts fold these in (position, then the burst field)
_BURST_POS_SALT = 0x6B01
_BURST_NOISE_SALT = 0x6B02


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of (R, n) along its last axis, pairwise at a power-of-two
    width (zero-padded): each row's order of additions is fixed by n
    alone, so a row's sum does not depend on the other rows."""
    n = v.shape[-1]
    width = pow2_ceil(max(n, 1))
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def awgn(key, samples, snr_db: float) -> torch.Tensor:
    """Complex white noise at `snr_db` relative to the mean sample
    power of each lane: key (R, 2) and samples (R, n, 2), or one key
    (2,) and one lane (n, 2)."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    one = x.dim() == 2
    if one:
        x, key = x[None], key[None]
    p_sig = _lane_sum(cplx.cabs2(x)) / x.shape[1]
    p_noise = p_sig / (10.0 ** (torch.as_tensor(
        snr_db, dtype=torch.float32, device=x.device) / 10.0))
    noise = threefry.normal(key, x.shape[1:]) \
        * torch.sqrt(p_noise / 2.0)[:, None, None]
    out = x + noise
    return out[0] if one else out


def apply_cfo(samples, eps: float) -> torch.Tensor:
    """Rotate (n, 2) samples by e^{+j*eps*n} (eps radians/sample)."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    n = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
    return cplx.cmul(x, cplx.cexp(float(np.float32(eps)) * n))


def apply_phase(samples, theta: float) -> torch.Tensor:
    x = torch.as_tensor(samples, dtype=torch.float32)
    return cplx.cmul(x, cplx.cexp(torch.full(
        x.shape[:-1], float(np.float32(theta)), device=x.device)))


def delay(key, samples, n_before: int, n_after: int = 0,
          noise_db: float = -30.0) -> torch.Tensor:
    """Pad the (n, 2) frame with low-level noise before and after (idle
    air time around a packet); key (2,)."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    p_sig = _lane_sum(cplx.cabs2(x)[None])[0] / x.shape[0]
    amp = torch.sqrt(p_sig * 10.0 ** (noise_db / 10.0) / 2.0)
    pad = threefry.normal(key[None], (n_before + n_after, 2))[0] * amp
    return torch.cat([pad[:n_before], x, pad[n_before:]], dim=0)


# ------------------------------------------------- batched link channel


def lane_key(seed, lanes, device=None) -> torch.Tensor:
    """The reference's per-lane key: ``fold_in(PRNGKey(seed), i)`` for
    each lane index of `lanes` (an int or a sequence): (2,) or (R, 2).
    Every draw of a lane folds off this key, so the lane's noise is the
    same batched, alone or as a whole stream."""
    return threefry.fold_in(threefry.prng_key(seed, device), torch.as_tensor(
        lanes, dtype=torch.int64, device=device))


def _roll_lanes(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Each lane of (R, L, 2) rolled forward by its own shift (R,):
    out[r, j] = x[r, (j - shift[r]) mod L], ``jnp.roll`` per lane."""
    L = x.shape[1]
    j = torch.arange(L, device=x.device)
    src = (j[None, :] - shift[:, None]) % L
    return torch.gather(x, 1, src[..., None].expand(-1, -1, 2))


def _noise_power(x, n_valid, snr_db):
    """Per-lane (signal power over the lane's valid samples, the AWGN
    power at its SNR)."""
    p_sig = _lane_sum(cplx.cabs2(x)) / torch.clamp(n_valid.float(), min=1.0)
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return p_sig, p_noise


def impair_graph(x, n_valid, snr_db, eps, delay, key) -> torch.Tensor:
    """The batched link channel: x (R, L, 2) TX samples of which the
    first n_valid[r] are lane r's frame (the rest is masked to zero
    here), then the lane's CFO (eps, rad/sample), its integer delay as
    a roll into the zero tail (delay + n_valid <= L) and AWGN at its
    own SNR (``inf`` adds exactly zero) from its key (R, 2). All
    per-lane values are (R,) tensors on x's device."""
    L = x.shape[1]
    idx = torch.arange(L, device=x.device)
    x = torch.where((idx[None, :] < n_valid[:, None])[..., None], x, 0.0)
    n = idx.float()
    x = cplx.cmul(x, cplx.cexp(eps[:, None] * n[None, :]))
    x = _roll_lanes(x, delay)
    _p_sig, p_noise = _noise_power(x, n_valid, snr_db)
    noise = threefry.normal(key, (L, 2))
    return x + noise * torch.sqrt(p_noise / 2.0)[:, None, None]


def sco_resample_graph(x, sco) -> torch.Tensor:
    """Sampling-clock-offset resample of (R, n, 2) by each lane's sco
    (R,): linear interpolation at positions n * (1 + sco); sco == 0
    returns x exactly, positions past the end take the last sample."""
    n = x.shape[1]
    pos = torch.arange(n, dtype=torch.float32, device=x.device)[None, :] \
        * (1.0 + sco[:, None])
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    frac = (pos - i0.float())[..., None]

    def at(i):
        return torch.gather(x, 1, i[..., None].expand(-1, -1, 2))
    return at(i0) * (1.0 - frac) + at(i1) * frac


def _burst_graph(x, p_sig, every, blen, bdb, key) -> torch.Tensor:
    """Seeded interference bursts on (R, L, 2): a blen-sample noise
    burst every `every` samples at bdb dB relative to the lane's signal
    power, its phase drawn off the lane key's burst salt; every == 0
    adds exactly zero."""
    on = every > 0
    safe = torch.clamp(every, min=1)
    off = threefry.randint(threefry.fold_in(key, _BURST_POS_SALT), (),
                           0, safe)
    idx = torch.arange(x.shape[1], device=x.device)
    in_burst = on[:, None] & (torch.remainder(
        idx[None, :] - off[:, None], safe[:, None]) < blen[:, None])
    amp = torch.where(on, torch.sqrt(p_sig * 10.0 ** (bdb / 10.0) / 2.0),
                      torch.zeros_like(p_sig))
    noise = threefry.normal(threefry.fold_in(key, _BURST_NOISE_SALT),
                            x.shape[1:])
    return x + noise * (amp[:, None] * in_burst.float())[..., None]


def impair_profile_graph(x, n_valid, snr_db, eps, delay, key, taps, sco,
                         drift, burst_every, burst_len, burst_db,
                         with_bursts: bool = True) -> torch.Tensor:
    """The profiled batched channel: :func:`impair_graph` with the
    physical faults composed in, each a per-lane value:

        mask pad -> multipath FIR (taps (R, T, 2)) -> SCO resample ->
        CFO + drift phase (theta = eps*n + drift*n^2/2) -> delay ->
        AWGN (the bare lane key) -> bursts (the key's fold-ins)

    At the neutral parameters (one-hot taps, sco = drift = 0,
    burst_every = 0) each added step is an exact identity and the AWGN
    draws the same key, so a flat lane equals :func:`impair_graph`.
    The FIR rings T - 1 samples past n_valid: keep delay + n_valid +
    T - 1 <= L. ``with_bursts`` False skips the burst draw (no lane
    bursts)."""
    L = x.shape[1]
    idx = torch.arange(L, device=x.device)
    x = torch.where((idx[None, :] < n_valid[:, None])[..., None], x, 0.0)
    x = multipath(x, taps)
    x = sco_resample_graph(x, sco)
    n = idx.float()[None, :]
    theta = eps[:, None] * n + 0.5 * drift[:, None] * n * n
    x = cplx.cmul(x, cplx.cexp(theta))
    x = _roll_lanes(x, delay)
    p_sig, p_noise = _noise_power(x, n_valid, snr_db)
    x = x + threefry.normal(key, (L, 2)) \
        * torch.sqrt(p_noise / 2.0)[:, None, None]
    if not with_bursts:
        return x
    return _burst_graph(x, p_sig, burst_every, burst_len, burst_db, key)


def _profile_consts(names, device):
    """Per-lane profile names -> the (taps, sco, drift, burst_every,
    burst_len, burst_db) tensors of the profiled graph, and whether any
    lane bursts."""
    arrs = chanprof.lane_arrays(names)
    consts = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in arrs)
    return consts, bool(any(chanprof.get_profile(n).burst_every
                            for n in names))


def _lane_vec(v, r: int, dtype, device) -> torch.Tensor:
    """A scalar or per-lane value as an (r,) tensor on `device`."""
    np_dtype = {torch.float32: np.float32, torch.int64: np.int64}[dtype]
    a = np.broadcast_to(np.asarray(v, np_dtype), (r,)).copy()
    return torch.from_numpy(a).to(device)


def impair_many_graph(x_b, n_valid, snr_db, eps, delay, seed, out_len: int,
                      profile_key=None, lanes=None) -> torch.Tensor:
    """The batched channel over a TX batch x_b (R, L, 2): pad to
    out_len, derive lane r's key as ``lane_key(seed, lanes[r])``
    (lanes default 0..R-1) and apply every lane's impairments.
    ``profile_key`` (per-lane profile names, or None) routes through
    :func:`impair_profile_graph`. Per-lane values are (R,) tensors on
    x_b's device."""
    dev = x_b.device
    r = x_b.shape[0]
    x = torch.nn.functional.pad(x_b.to(torch.float32),
                                (0, 0, 0, out_len - x_b.shape[1]))
    if lanes is None:
        lanes = torch.arange(r, device=dev)
    keys = lane_key(seed, lanes, dev).reshape(r, 2)
    if profile_key is None:
        return impair_graph(x, n_valid, snr_db, eps, delay, keys)
    (taps, sco, drift, b_ev, b_ln, b_db), wb = _profile_consts(
        profile_key, dev)
    return impair_profile_graph(x, n_valid, snr_db, eps, delay, keys, taps,
                                sco, drift, b_ev.long(), b_ln.long(), b_db,
                                with_bursts=wb)


def impair_many(x_b, n_valid, snr_db, eps, delay, seed, out_len: int = None,
                profile=None) -> torch.Tensor:
    """Batched per-lane channel: the (R, L, 2) TX batch (on its device)
    -> (R, out_len, 2) impaired captures on the same device. n_valid,
    snr_db, eps and delay are scalars or per-lane sequences; `seed` one
    int, lane keys by fold-in (:func:`lane_key`). Row i equals
    :func:`impair_one` at ``lane=i`` bit for bit. ``profile`` is a
    channel-profile name, a per-lane sequence or None (unprofiled: the
    ZIRIA_CHANNEL_PROFILE default is not read at this level)."""
    x_b = torch.as_tensor(x_b, dtype=torch.float32)
    r, dev = int(x_b.shape[0]), x_b.device
    if out_len is None:
        out_len = int(x_b.shape[1])
    names = chanprof.resolve_profiles(profile, r, use_env=False)
    with dispatch.timed("channel.impair_many"):
        return impair_many_graph(
            x_b, _lane_vec(n_valid, r, torch.int64, dev),
            _lane_vec(snr_db, r, torch.float32, dev),
            _lane_vec(eps, r, torch.float32, dev),
            _lane_vec(delay, r, torch.int64, dev), seed, int(out_len),
            names)


def impair_one(samples, snr_db, eps, delay, seed, lane: int, out_len: int,
               profile=None, device="cuda") -> torch.Tensor:
    """The per-frame twin of :func:`impair_many`: one frame (n, 2),
    zero-padded to out_len, through the same graph with lane `lane`'s
    key; ``profile`` is this lane's profile name or None. (out_len, 2)
    on `device`, equal to row `lane` of the batched call."""
    s = (samples if torch.is_tensor(samples)
         else torch.from_numpy(np.asarray(samples, np.float32)))
    s = s.to(device=device, dtype=torch.float32)
    names = chanprof.resolve_profiles(profile, 1, use_env=False)
    x = torch.zeros((1, int(out_len), 2), dtype=torch.float32, device=device)
    x[0, :s.shape[0]] = s
    with dispatch.timed("channel.impair"):
        return impair_many_graph(
            x, _lane_vec(s.shape[0], 1, torch.int64, device),
            _lane_vec(snr_db, 1, torch.float32, device),
            _lane_vec(eps, 1, torch.float32, device),
            _lane_vec(delay, 1, torch.int64, device), seed, int(out_len),
            names, lanes=torch.tensor([int(lane)], device=device))[0]


def impair_stream(stream, n_signal: int, snr_db, eps, seed, profile=None,
                  lane: int = 0, device="cuda") -> np.ndarray:
    """Whole-stream impairments for the streaming receivers' stimulus
    (``link.stream_many``): the profile's multipath FIR and SCO resample
    (``profiles.np_apply_taps`` / ``np_apply_sco``), one CFO (+ drift)
    rotation over the whole stream, AWGN at `snr_db` relative to the
    mean power of the `n_signal` frame samples (``inf`` adds none), then
    the profile's bursts. Host float64 math as in the reference; the
    draws fold off ``lane_key(seed, lane)`` exactly as the batched
    channel's, made on `device`. Returns the (n, 2) float32 stream."""
    prof = None
    names = chanprof.resolve_profiles(profile, 1, use_env=False)
    if names is not None:
        prof = chanprof.get_profile(names[0])
    x = np.asarray(stream, np.float32)
    drift = 0.0
    if prof is not None:
        x = chanprof.np_apply_taps(x, prof)
        x = chanprof.np_apply_sco(x, prof.sco)
        drift = float(prof.drift)
    if eps or drift:
        n = np.arange(x.shape[0], dtype=np.float64)
        theta = float(eps) * n + 0.5 * drift * n * n
        c = np.cos(theta)
        s = np.sin(theta)
        x = np.stack([x[:, 0] * c - x[:, 1] * s,
                      x[:, 0] * s + x[:, 1] * c], axis=-1)
        x = x.astype(np.float32)
    need_draws = np.isfinite(snr_db) or (prof is not None
                                         and prof.burst_every)
    key = lane_key(seed, [int(lane)], device) if need_draws else None
    p_sig = (float(np.sum(x.astype(np.float64) ** 2)
                   / max(int(n_signal), 1)) if need_draws else 0.0)
    if np.isfinite(snr_db):
        p_noise = p_sig / (10.0 ** (float(snr_db) / 10.0))
        noise = threefry.normal(key, x.shape)[0].cpu().numpy() \
            .astype(np.float64)
        x = (x + noise * np.sqrt(p_noise / 2.0)).astype(np.float32)
    if prof is not None and prof.burst_every:
        off = int(threefry.randint(threefry.fold_in(key, _BURST_POS_SALT),
                                   (), 0, prof.burst_every)[0])
        in_burst = chanprof.np_burst_mask(x.shape[0], prof, off)
        amp = chanprof.np_burst_amp(p_sig, prof)
        bn = threefry.normal(threefry.fold_in(key, _BURST_NOISE_SALT),
                             x.shape)[0].cpu().numpy().astype(np.float64)
        x = (x + bn * (amp * in_burst.astype(np.float64))[:, None]) \
            .astype(np.float32)
    return x


def impair_profile_point_graph(frames, keys, snr_db,
                               profile_key: str) -> torch.Tensor:
    """Perfect-sync profiled channel of the BER surfaces
    (``link.loopback_ber_bits``, ``link.sweep_ber``'s profile axis):
    frames (R, n, 2) through the profile's multipath, SCO resample and
    drift phase (no CFO, no delay), AWGN at `snr_db` through
    :func:`awgn` with the caller's split keys (R, 2), then the
    profile's bursts off each key's fold-ins."""
    r, dev = frames.shape[0], frames.device
    (taps, sco, drift, b_ev, b_ln, b_db), wb = _profile_consts(
        (profile_key,) * r, dev)
    x = multipath(frames.to(torch.float32), taps)
    x = sco_resample_graph(x, sco)
    n = torch.arange(x.shape[1], dtype=torch.float32, device=dev)[None, :]
    x = cplx.cmul(x, cplx.cexp(0.5 * drift[:, None] * n * n))
    p_sig = _lane_sum(cplx.cabs2(x)) / x.shape[1]
    x = awgn(keys, x, snr_db)
    if not wb:
        return x
    return _burst_graph(x, p_sig, b_ev.long(), b_ln.long(), b_db, keys)


def _fir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal FIR of each lane of u (R, n) by its taps v (R, T), same
    length out: out[k] = sum_j u[k - j] * v[j], in tap order."""
    n = u.shape[1]
    out = u * v[:, :1]
    for j in range(1, v.shape[1]):
        out = out + torch.nn.functional.pad(u[:, :n - j], (j, 0)) \
            * v[:, j:j + 1]
    return out


def multipath(samples, taps_pair) -> torch.Tensor:
    """Complex FIR channel, causal, same length out: samples (n, 2)
    with taps (T, 2), or a batch (R, n, 2) with per-lane taps (R, T, 2).
    float32 throughout; a one-hot tap vector is an exact identity."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    t = torch.as_tensor(taps_pair, dtype=torch.float32, device=x.device)
    one = x.dim() == 2
    if one:
        x, t = x[None], t[None]
    re = _fir(x[..., 0], t[..., 0]) - _fir(x[..., 1], t[..., 1])
    im = _fir(x[..., 0], t[..., 1]) + _fir(x[..., 1], t[..., 0])
    out = torch.stack([re, im], dim=-1)
    return out[0] if one else out


def impaired_capture(mbps: int, n_bytes: int, seed: int, cfo: float = 0.002,
                     pre: int = 60, post: int = 40, noise: float = 0.03,
                     floor: float = 0.02, scale: float = 1024.0,
                     add_fcs: bool = False, device="cuda"):
    """A deterministic receiver test vector: one TX frame with CFO,
    surrounded by noise, plus AWGN, quantized to the complex16 wire
    format (int16 IQ pairs); the numpy draws of the reference's recipe
    (the one that made examples/golden/wifi_rx.infile). Returns
    (psdu_bytes, samples)."""
    from ziria_tpu_torch.phy.wifi import tx

    rng = np.random.default_rng(seed)
    psdu = rng.integers(0, 256, n_bytes).astype(np.uint8)
    frame = tx.encode_frame(psdu, mbps, add_fcs=add_fcs, device=device)
    x = np.concatenate([
        rng.normal(scale=floor, size=(pre, 2)).astype(np.float32),
        apply_cfo(frame, cfo).cpu().numpy(),
        rng.normal(scale=floor, size=(post, 2)).astype(np.float32)])
    x = (x + rng.normal(scale=noise, size=x.shape)).astype(np.float32)
    xi = np.clip(np.round(x * scale), -32768, 32767).astype(np.int16)
    return psdu, xi
