"""Packet detection, CFO estimation/correction, channel estimation
(counterpart of ziria_tpu/ops/sync.py).

Every function takes a batch of captures (B, n, 2) where the
reference took one capture under ``vmap``. The sliding sums and the
LTS cross-correlation are short FIR filters; they are written as sums
of shifted slices (one elementwise pass per tap) rather than cuDNN
convolutions, so the float32 arithmetic is the same on the CPU and on
the card and no convolution algorithm (TF32, FFT) can move detection
or the peak-pick.
"""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.ops import cplx
from ziria_tpu_torch.ops.ofdm import LTS_FREQ, N_FFT, TIME_SCALE, \
    lts_time_symbol
from ziria_tpu_torch.utils import telemetry


def _fir_valid(x: torch.Tensor, taps) -> torch.Tensor:
    """Valid-mode correlation along axis 1: out[:, k] = sum_j
    x[:, k + j] * taps[j], accumulated tap by tap."""
    m = x.shape[1] - len(taps) + 1
    with telemetry.span("sync.fir_valid"):
        acc = x[:, 0:m] * float(taps[0])
        for j in range(1, len(taps)):
            acc = acc + x[:, j:j + m] * float(taps[j])
    return acc


def _sliding_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding window sums along axis 1: out[:, k] = sum(x[:, k:k+w]).

    Integer input takes exact cumsum differences; float input sums
    only the w local terms, as the reference's w-tap convolution does
    (a float prefix-sum difference loses precision once the prefix
    dwarfs the window)."""
    if not torch.is_floating_point(x):
        c = torch.cumsum(x, dim=1)
        c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
        return c[:, w:] - c[:, :-w]
    m = x.shape[1] - w + 1
    with telemetry.span("sync.sliding_sum"):
        acc = x[:, 0:m]
        for j in range(1, w):
            acc = acc + x[:, j:j + m]
    return acc


def sts_autocorr(samples: torch.Tensor, window: int = 48):
    """Normalized lag-16 autocorrelation metric of (B, n, 2) streams.
    Returns (metric (B, n-16-window+1), corr pairs)."""
    a, b = samples[:, :-16], samples[:, 16:]
    prod = cplx.cmul_conj(b, a)            # r[k+16] * conj(r[k])
    corr = _sliding_sum(prod, window)
    energy = _sliding_sum(cplx.cabs2(b), window)
    metric = torch.sqrt(cplx.cabs2(corr)) / (energy + 1e-9)
    return metric, corr


def detect_packet(samples: torch.Tensor, window: int = 48,
                  threshold: float = 0.75, limit=None):
    """(detected (B,) bool, start (B,) int64): the first index where
    the STS autocorrelation metric crosses the threshold. ``limit``
    (B,) caps the considered positions to those a limit-length capture
    would evaluate (see :func:`locate_frame`)."""
    metric, _ = sts_autocorr(samples, window)
    above = metric > threshold
    if limit is not None:
        pos = torch.arange(above.shape[1], device=above.device)
        above = above & (pos[None, :] < (limit - 16 - window + 1)[:, None])
    detected = above.any(dim=1)
    # torch's argmax takes no bool; over 0/1 it returns the first 1
    start = torch.argmax(above.to(torch.uint8), dim=1)
    return detected, start


def estimate_cfo_sts(samples: torch.Tensor, n_pairs: int = 96):
    """Coarse CFO (rad/sample) from lag-16 products over the STS of
    aligned frames (B, >=160, 2)."""
    x = samples[:, :160]
    s = cplx.cmul_conj(x[:, 16:16 + n_pairs], x[:, :n_pairs]).sum(dim=1)
    return cplx.cangle(s) / 16.0


def estimate_cfo_lts(samples: torch.Tensor):
    """Fine CFO from the two LTS symbols (192..256..320) of aligned
    frames (lag-64 product)."""
    s = cplx.cmul_conj(samples[:, 256:320], samples[:, 192:256]).sum(dim=1)
    return cplx.cangle(s) / 64.0


def correct_cfo(samples: torch.Tensor, eps: torch.Tensor):
    """Multiply each lane (B, n, 2) by e^{-j*eps[b]*n}."""
    n = torch.arange(samples.shape[1], dtype=torch.float32,
                     device=samples.device)
    rot = cplx.cexp(-eps[:, None] * n)
    return cplx.cmul(samples, rot)


def dynamic_slice(x: torch.Tensor, start: torch.Tensor, size: int):
    """Rows [start[b], start[b]+size) of each lane of (B, n, 2) for
    non-negative starts, a start past n - size clamped to it as the
    reference's ``lax.dynamic_slice`` clamps it."""
    s = start.clamp(0, x.shape[1] - size)
    idx = s[:, None] + torch.arange(size, device=x.device)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def lts_pair_metric(samples: torch.Tensor, limit=None):
    """LTS timing metric of (B, n, 2) streams: cross-correlation with
    the known long training symbol, the two 64-apart peak candidates
    summed, so pair[:, k] is large where the first LTS starts at k.
    Returns (B, n-127); positions at or past ``limit`` - 127 hold -1."""
    n = samples.shape[1]
    ref = lts_time_symbol()                  # correlate with conj(lts)
    x0, x1 = samples[..., 0], samples[..., 1]
    r0, r1 = ref[:, 0], -ref[:, 1]
    re = _fir_valid(x0, r0) - _fir_valid(x1, r1)
    im = _fir_valid(x0, r1) + _fir_valid(x1, r0)
    c = re ** 2 + im ** 2                    # (B, n-63)
    pair = c[:, :-64] + c[:, 64:]
    pos = torch.arange(pair.shape[1], device=samples.device)
    lim = torch.full((samples.shape[0],), n, device=samples.device) \
        if limit is None else limit
    return torch.where(pos[None, :] < (lim - 127)[:, None], pair,
                       torch.full_like(pair, -1.0))


def locate_frame(samples: torch.Tensor, limit=None, window: int = 48,
                 threshold: float = 0.75):
    """Locate and align a frame in each lane of (B, n, 2): STS
    detection gate, LTS cross-correlation timing, coarse+fine CFO.
    Returns (found (B,), frame_start (B,) int64, cfo (B,) float32).

    ``limit`` (B,), default the full length, caps the detection gate
    and the peak-pick to the positions a limit-length capture would
    evaluate, so a lane padded past its own bucket to the batch's
    common one gives the same answer as alone."""
    detected, _coarse = detect_packet(samples, window, threshold,
                                      limit=limit)
    pair = lts_pair_metric(samples, limit=limit)
    lts1 = torch.argmax(pair, dim=1)
    frame_start = (lts1 - 192).clamp(min=0)
    head = dynamic_slice(samples, frame_start, 320)
    eps_c = estimate_cfo_sts(head)
    eps_f = estimate_cfo_lts(correct_cfo(head, eps_c))
    return detected, frame_start, eps_c + eps_f


def locate_frames(samples: torch.Tensor, k: int, limit=None,
                  window: int = 48, threshold: float = 0.75,
                  min_run: int = 33, dead_zone: int = 320,
                  align_back: int = 32, align_span: int = 416,
                  overflow_limit=None):
    """Up to ``k`` frame starts in each multi-frame chunk of (B, n, 2),
    as the reference's ``locate_frames`` finds them in one: a plateau
    gate (``min_run`` consecutive positions above ``threshold``), top-K
    extraction (take the first eligible plateau start, suppress
    ``dead_zone`` positions past it, ``k`` times), and a local LTS
    peak-pick in ``[d - align_back, d - align_back + align_span)`` of
    each crossing d. Returns (found (B, k), starts (B, k) int64,
    ascending, -1 where not found; overflow (B,): an eligible plateau
    remains past the k taken).

    ``limit`` (B,) caps the plateau gate and the peak-pick to the
    positions a limit-length capture would evaluate; ``overflow_limit``
    (B,) caps the positions the overflow scan considers. The k
    extraction steps are k tensor steps with no host read; argmax takes
    the first index on ties, as the reference's does."""
    b, n = samples.shape[:2]
    dev = samples.device
    full = torch.full((b,), n, dtype=torch.int64, device=dev)
    lim = full if limit is None else limit
    metric, _ = sts_autocorr(samples, window)
    pos = torch.arange(metric.shape[1], device=dev)
    above = (metric > threshold) \
        & (pos[None, :] < (lim - 16 - window + 1)[:, None])
    # ok[:, p] <=> positions [p, p + min_run) all above: the exact
    # integer path of _sliding_sum
    ok = _sliding_sum(above.to(torch.int32), min_run) == min_run
    idx = torch.arange(ok.shape[1], device=dev)[None, :]
    next_free = torch.zeros((b,), dtype=torch.int64, device=dev)
    found, d = [], []
    for _ in range(k):
        cand = ok & (idx >= next_free[:, None])
        f = cand.any(dim=1)
        di = torch.argmax(cand.to(torch.uint8), dim=1)   # first eligible
        next_free = torch.where(f, di + dead_zone, next_free)
        found.append(f)
        d.append(di)
    found, d = torch.stack(found, 1), torch.stack(d, 1)
    rem = ok & (idx >= next_free[:, None])
    if overflow_limit is not None:
        rem = rem & (idx < overflow_limit[:, None])
    overflow = rem.any(dim=1)
    pair = lts_pair_metric(samples, limit=lim)               # (B, P)
    pidx = torch.arange(pair.shape[1], device=dev)
    lo = (d - align_back)[..., None]
    local = torch.where((pidx >= lo) & (pidx < lo + align_span),
                        pair[:, None, :], pair.new_full((), -1.0))
    starts = torch.argmax(local, dim=2) - 192
    return found, torch.where(found, starts, torch.full_like(starts, -1)), \
        overflow


def estimate_channel(samples: torch.Tensor):
    """Channel estimate (B, 64, 2) from the two LTS symbols of aligned,
    CFO-corrected frames (zero on unused bins, H == 1 for an identity
    channel)."""
    l1 = cplx.fft_pair(samples[:, 192:256])
    l2 = cplx.fft_pair(samples[:, 256:320])
    avg = (l1 + l2) * (0.5 / TIME_SCALE)
    ref = np.zeros(N_FFT, np.float32)
    ref[(np.arange(-26, 27) % N_FFT)] = LTS_FREQ.astype(np.float32)
    return avg * torch.from_numpy(ref).to(samples.device)[:, None]
