"""Frame-batched library receiver (counterpart of
ziria_tpu/backend/framebatch.py ``receive_many`` :210 and
``_mixed_decode_tail`` :287)."""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import torch

from ziria_tpu_torch.ops import cplx
from ziria_tpu_torch.phy.wifi import rx as _rx
from ziria_tpu_torch.phy.wifi.params import N_SERVICE_BITS, RATE_INDEX, \
    RATES
from ziria_tpu_torch.utils import geometry
from ziria_tpu_torch.utils.dispatch import pad_lanes


def batched_acquire_enabled(batched_acquire=None) -> bool:
    """The ``batched_acquire`` knob: the explicit value, else the
    ZIRIA_BATCHED_ACQUIRE environment variable (default on)."""
    if batched_acquire is not None:
        return bool(batched_acquire)
    return os.environ.get("ZIRIA_BATCHED_ACQUIRE", "1") != "0"


def receive_many(captures: Sequence[Any], check_fcs: bool = False,
                 max_samples: int = 1 << 16, device="cuda", *,
                 viterbi_window: Optional[int] = None,
                 viterbi_metric: Optional[str] = None,
                 viterbi_radix: Optional[int] = None,
                 batched_acquire: Optional[bool] = None,
                 sco_track: Optional[bool] = None,
                 fused_demap: Optional[bool] = None) -> List[Any]:
    """N captures ((n, 2) float32 array-likes) -> N :class:`rx.RxResult`s,
    field for field the reference's ``receive_many``:

    1. acquire (``rx.acquire_many``): detect, LTS peak-pick, CFO,
       alignment and SIGNAL decode of every lane in one batch; the
       host parses the headers and picks one symbol bucket. With
       ``batched_acquire=False`` (or ZIRIA_BATCHED_ACQUIRE=0), the
       per-capture ``rx._acquire_frame`` instead;
    2. gather (``rx.gather_segments_many``, or ``rx._padded_segment``
       per capture): each decodable lane's data region at its own
       start, derotated by its own CFO;
    3. decode (``rx.decode_data_mixed``): every rate's front, then one
       Viterbi over the whole mixed-rate batch (the CUDA ACS and
       traceback kernels on the card); with ``fused_demap`` (or
       ZIRIA_FUSED_DEMAP=1) one rate-independent front and the
       rate-switched fused kernel; ``sco_track`` (or
       ZIRIA_RX_SCO_TRACK=1) adds pilot phase-ramp tracking;
    4. with ``check_fcs``, the masked CRC of every lane.

    Runs on `device` ("cuda" by default; the tests pass "cpu", where
    the kernels' plain versions run). A window, a quantized metric and
    radix 4 raise NotImplementedError naming the ROADMAP item that
    ports them."""
    batched_acquire = batched_acquire_enabled(batched_acquire)
    sco_track = _rx.sco_track_enabled(sco_track)
    fused_demap = _rx.fused_demap_enabled(fused_demap) \
        and _rx._fused_front_applies(viterbi_window, viterbi_metric)
    _rx.check_decode_knobs("receive_many", viterbi_window, viterbi_metric,
                           viterbi_radix, fused_demap)
    device = _rx.check_device(device, "receive_many")
    with cplx.exact_fp32():
        if batched_acquire:
            results, x_dev, acqs = _rx.acquire_many(captures, max_samples,
                                                    device)
        else:
            results, acqs = [None] * len(captures), []
            for i, s in enumerate(captures):
                res, acq = _rx._acquire_frame(s, max_samples, device)
                if acq is None:
                    results[i] = res
                else:
                    acqs.append((i, acq))
        if not acqs:
            return results
        # one common symbol bucket for the whole batch: shorter frames
        # carry zero-LLR erasures up to it
        n_sym_b = max(geometry.sym_bucket(a.n_sym) for _i, a in acqs)
        padded = pad_lanes(acqs)
        if batched_acquire:
            segs = _rx.gather_segments_many(x_dev, [a for _i, a in padded],
                                            n_sym_b)
        else:
            segs = torch.stack([_rx._padded_segment(a, n_sym_b, device)
                                for _i, a in padded])
        return _mixed_decode_tail(acqs, padded, segs, n_sym_b, results,
                                  check_fcs, sco_track, fused_demap)


def _mixed_decode_tail(acqs, padded, segs, n_sym_b: int,
                       results: List[Any], check_fcs: bool,
                       sco_track: bool = False, fused_demap: bool = False):
    """The mixed-rate decode over the lane-padded segments, the
    batched FCS check when asked, and the per-lane PSDU slices.
    `acqs` is [(i, acq)] for the real lanes, `padded` the pad_lanes
    list `segs` was built from."""
    ridx = [RATE_INDEX[a.rate_mbps] for _i, a in padded]
    nbits = [a.n_sym * RATES[a.rate_mbps].n_dbps for _i, a in padded]
    clear_dev = _rx.decode_data_mixed(segs, ridx, nbits, n_sym_b,
                                      sco_track=sco_track,
                                      fused_demap=fused_demap)
    crc_b = None
    if check_fcs:
        npsdu = torch.tensor([8 * a.length_bytes for _i, a in padded],
                             device=segs.device)
        crc_b = _rx.crc_psdu_many_graph(clear_dev, npsdu).cpu().numpy()
    clear = clear_dev.cpu().numpy()
    for k, (i, a) in enumerate(acqs):
        psdu = clear[k][N_SERVICE_BITS: N_SERVICE_BITS
                        + 8 * a.length_bytes]
        crc = bool(crc_b[k]) if check_fcs else None
        results[i] = _rx.RxResult(True, a.rate_mbps, a.length_bytes,
                                  psdu, crc)
    return results
