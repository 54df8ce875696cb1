"""The comparison that decides ``correct``: the port's answers against
the generator's truth and against the plain reference receiver of
``benchmark/reference/rx.py``, which decodes the same captures again
from the samples alone. Each number compared is a count of frames that
differ, and its limit is 0: every true frame is emitted once, at its
true start, with the right rate, length, PSDU bits and FCS verdict."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import rx as ref_rx


def same_result(res, frame) -> bool:
    """A port ``RxResult`` equal to the truth of its frame."""
    return (res is not None and bool(res.ok)
            and int(res.rate_mbps) == frame.mbps
            and int(res.length_bytes) == frame.psdu.size
            and res.crc_ok is True
            and np.array_equal(np.asarray(res.psdu_bits, np.uint8),
                               frame.bits))


def same_as_reference(res, ref: Dict, frame, start_offset: int = 0,
                      start: Optional[int] = None) -> bool:
    """A port ``RxResult`` field for field equal to the reference's
    decode of the same samples, the reference's start at the truth's
    (`start_offset`: where the reference's samples began) and, where the
    port reports one, at the port's `start`."""
    ref_start = ref["start"] + start_offset
    return (res is not None and ref_start == frame.start
            and (start is None or start == ref_start)
            and bool(res.ok) == ref["ok"]
            and int(res.rate_mbps) == ref["rate_mbps"]
            and int(res.length_bytes) == ref["length_bytes"]
            and res.crc_ok == ref["crc_ok"]
            and np.array_equal(np.asarray(res.psdu_bits, np.uint8),
                               ref["psdu_bits"]))


def reference_frames(captures: List[np.ndarray], dtype=torch.float32,
                     device="cpu", block: int = 64) -> List[Dict]:
    """The reference receiver over captures, in blocks of `block`."""
    r = ref_rx.Receiver(dtype, device)
    out: List[Dict] = []
    for a in range(0, len(captures), block):
        out += r.receive(captures[a:a + block])
    return out


def verdict(numbers) -> bool:
    """True iff every number with a limit is within it."""
    return all(lim is None or val <= lim for _n, val, lim in numbers)
