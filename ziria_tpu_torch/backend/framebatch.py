"""Frame-batched library receiver (counterpart of
ziria_tpu/backend/framebatch.py ``receive_many`` :210 and
``_mixed_decode_tail`` :287)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from ziria_tpu_torch.ops import cplx
from ziria_tpu_torch.phy.wifi import rx as _rx
from ziria_tpu_torch.phy.wifi.params import N_SERVICE_BITS, RATE_INDEX, \
    RATES
from ziria_tpu_torch.utils import geometry
from ziria_tpu_torch.utils.dispatch import pad_lanes

# the reference's decode knobs, the value (besides None) that selects
# the default path this port runs, and the ROADMAP.md item that ports
# the rest
_KNOBS = {
    "viterbi_window": ((0,), "queue 1, 'Decode modes off the default'"),
    "viterbi_metric": (("float32",),
                       "queue 1, 'Decode modes off the default'"),
    "viterbi_radix": ((2,), "queue 1, 'Decode modes off the default'"),
    "batched_acquire": ((True,), "queue 1, 'Per-capture receive'"),
    "sco_track": ((False,), "queue 1, 'Per-capture receive'"),
    "fused_demap": ((False,), "queue 2, '_make_mixed_fused_acs_kernel'"),
}


def _require_default(name: str, value) -> None:
    allowed, item = _KNOBS[name]
    if value is not None and value not in allowed:
        raise NotImplementedError(
            f"receive_many({name}={value!r}) is not ported yet; it runs "
            f"only the default path (ROADMAP.md {item})")


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
       host parses the headers and picks one symbol bucket;
    2. gather (``rx.gather_segments_many``): each decodable lane's data
       region at its own start, derotated by its own CFO;
    3. decode (``rx.decode_data_mixed``): every rate's front, then one
       Viterbi over the whole mixed-rate batch (the CUDA ACS and
       traceback kernels on the card);
    4. with ``check_fcs``, the masked CRC of every lane.

    Runs on `device` ("cuda" by default; the tests pass "cpu", where
    the kernels' plain versions run). The decode knobs accept only
    their default values; any other raises NotImplementedError naming
    the ROADMAP item that ports it."""
    for name, value in (("viterbi_window", viterbi_window),
                        ("viterbi_metric", viterbi_metric),
                        ("viterbi_radix", viterbi_radix),
                        ("batched_acquire", batched_acquire),
                        ("sco_track", sco_track),
                        ("fused_demap", fused_demap)):
        _require_default(name, value)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "receive_many: device='cuda' but torch.cuda.is_available() is "
            "False (pass device='cpu' to run on the CPU)")
    with cplx.exact_fp32():
        results, x_dev, acqs = _rx.acquire_many(captures, max_samples,
                                                device)
        if not acqs:
            return results
        # one common symbol bucket for the whole batch: shorter frames
        # carry zero-LLR erasures up to it
        n_sym_b = max(geometry.sym_bucket(a.n_sym) for _i, a in acqs)
        padded = pad_lanes(acqs)
        segs = _rx.gather_segments_many(x_dev, [a for _i, a in padded],
                                        n_sym_b)
        return _mixed_decode_tail(acqs, padded, segs, n_sym_b, results,
                                  check_fcs)


def _mixed_decode_tail(acqs, padded, segs, n_sym_b: int,
                       results: List[Any], check_fcs: bool):
    """The mixed-rate decode over the lane-padded segments, the
    batched FCS check when asked, and the per-lane PSDU slices.
    `acqs` is [(i, acq)] for the real lanes, `padded` the pad_lanes
    list `segs` was built from."""
    ridx = [RATE_INDEX[a.rate_mbps] for _i, a in padded]
    nbits = [a.n_sym * RATES[a.rate_mbps].n_dbps for _i, a in padded]
    clear_dev = _rx.decode_data_mixed(segs, ridx, nbits, n_sym_b)
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
