"""Long-capture packet search (counterpart of ziria_tpu/phy/search.py).

The receiver detects packets on a live sample stream one at a time; an
offline workflow wants the dual: scan a long capture for every packet
start, then decode them all. The metric is the streaming detector's STS
lag-16 autocorrelation (``ops/sync.sts_autocorr``) over the whole
capture, on the device; every packet found is decoded by the
in-language receiver (``examples/wifi_rx.zir``) with its chunk-machine
steps batched across packets (``backend/framebatch.run_many``).

At capture scale the metric is a windowed map over one long stream:
with ``mesh=`` it splits over the mesh's ``sp`` axis with a halo
exchange (``parallel/streampar.sliding_parallel``), the capture padded
with zeros to a multiple of the axis and the padded windows trimmed.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np
import torch

from ziria_tpu_torch.ops.sync import sts_autocorr


def detection_metric(samples, window: int = 48, mesh=None,
                     axis: str = "sp", device="cuda") -> np.ndarray:
    """STS autocorrelation metric for every window position of a
    capture, computed on `device`, or with a mesh split over its `axis`
    with a halo exchange. samples: (n, 2) float pairs. Returns
    (n - 16 - window + 1,) float32."""
    samples = np.asarray(samples, np.float32)
    if mesh is None:
        x = torch.from_numpy(samples).to(device)
        m, _ = sts_autocorr(x[None], window)
        return m[0].cpu().numpy()

    from ziria_tpu_torch.parallel.streampar import sliding_parallel
    span = 16 + window                        # samples per metric value
    pad = (-len(samples)) % mesh.shape[axis]
    if pad:
        # zero samples give a ~zero metric (energy-normalized), and the
        # padded windows are trimmed below anyway
        samples = np.concatenate([samples, np.zeros((pad, 2), np.float32)])

    def fn(block):
        m, _ = sts_autocorr(block[None], window)
        return m[0]

    m = sliding_parallel(fn, samples, window=span, mesh=mesh, axis=axis)
    return m[: len(samples) - pad - span + 1] if pad else m


def find_packets(samples, threshold: float = 0.75, window: int = 48,
                 min_run: int = 33, min_gap: int = 320, mesh=None,
                 axis: str = "sp", device="cuda") -> np.ndarray:
    """Start indices of detection plateaus in a capture.

    A packet start is the first index of a run of at least `min_run`
    consecutive above-`threshold` windows (the streaming detector's
    n > 32 plateau requirement: a real STS plateau spans the whole short
    preamble, while the energy roll-off at a frame's END can produce a
    brief spike in the normalized metric), at least `min_gap` samples
    after the previous accepted plateau. Returns sorted indices into
    `samples`.
    """
    metric = detection_metric(samples, window=window, mesh=mesh,
                              axis=axis, device=device)
    hot = np.flatnonzero(metric > threshold)
    runs = []
    if hot.size:
        # maximal runs of consecutive indices
        cut = np.flatnonzero(np.diff(hot) > 1)
        lo = np.concatenate([[0], cut + 1])
        hi = np.concatenate([cut, [hot.size - 1]])
        runs = [(int(hot[a]), int(hot[b])) for a, b in zip(lo, hi)]
    starts = []
    last_end = None                 # end of the last ACCEPTED plateau
    for a, b in runs:
        if b - a + 1 < min_run:
            continue
        if last_end is None or a - last_end > min_gap:
            starts.append(a)
            last_end = b
    return np.asarray(starts, np.int64)


_RECEIVERS: Dict[str, object] = {}
_LOCK = threading.Lock()


def _receiver(device="cuda"):
    """The hybridized in-language receiver, compiled once per process
    and device (its chunk machines keep their captured graphs)."""
    key = str(torch.device(device))
    with _LOCK:
        if key not in _RECEIVERS:
            from ziria_tpu_torch.backend import hybrid as H
            from ziria_tpu_torch.frontend import compile_file
            src = os.path.join(os.path.dirname(__file__), "..", "..",
                               "examples", "wifi_rx.zir")
            if not os.path.exists(src):
                raise FileNotFoundError(
                    f"scan_and_decode needs the in-language receiver at "
                    f"{src} (pass comp= when running from an installed "
                    f"package without the examples tree)")
            _RECEIVERS[key] = H.hybridize(compile_file(src).comp,
                                          device=device)
        return _RECEIVERS[key]


def scan_and_decode(samples, mesh=None, axis: str = "sp",
                    threshold: float = 0.75,
                    max_frame_samples: int = 1 << 17,
                    comp=None, device="cuda"):
    """Find every packet in a long capture and decode them all as one
    frame batch. Returns [(start_index, payload_bits)] for packets
    whose in-language FCS validated; the receiver drops corrupted
    packets itself.

    samples: (n, 2) int16 IQ pairs (the complex16 wire format).
    `max_frame_samples` defaults past the longest legal 802.11a frame
    (4095-byte PSDU at 6 Mbps ~ 110k samples): a window truncated by
    this limit fails the FCS. `comp` overrides the receiver (any
    hybridized complex16 -> bit stream computer).
    """
    from ziria_tpu_torch.backend.framebatch import run_many

    arr = np.asarray(samples)
    starts = find_packets(arr, threshold=threshold, mesh=mesh,
                          axis=axis, device=device)
    if len(starts) == 0:
        return []
    hyb = comp if comp is not None else _receiver(device)

    bounds = list(starts[1:]) + [len(arr)]
    wins = []
    for s, nxt in zip(starts, bounds):
        lo = max(0, int(s) - 24)         # margin before the STS start
        hi = min(int(nxt), int(s) + max_frame_samples, len(arr))
        wins.append([p for p in arr[lo:hi]])

    out = []
    for s, r in zip(starts, run_many(hyb, wins)):
        bits = np.asarray(r.out_array(), np.uint8)
        if bits.size:
            out.append((int(s), bits))
    return out
