"""The default bucket rules of the receive path and the environment
readers of its decode knobs (counterpart of
ziria_tpu/utils/geometry.py: ``Geometry`` at its defaults, :166-192,
the knobs' legal values :63-65 and the readers ``env_viterbi_window``,
``env_viterbi_metric``, ``env_viterbi_radix``, ``env_fused_demap`` and
``env_sco_track``, :80-134)."""

from __future__ import annotations

import os

from ziria_tpu_torch.utils.dispatch import pow2_bucket

#: valid Viterbi metric dtypes (ops/viterbi.METRIC_DTYPES aliases this)
VITERBI_METRICS = ("float32", "int16", "int8")
#: valid Viterbi ACS radixes (ops/viterbi.RADIXES aliases this)
VITERBI_RADIXES = (2, 4)

SYM_BUCKET_MIN = 4
CAPTURE_BUCKET_MIN = 512


def sym_bucket(n_sym: int) -> int:
    """Power-of-two DATA symbol bucket, floored at 4."""
    return pow2_bucket(n_sym, SYM_BUCKET_MIN)


def capture_bucket(n: int) -> int:
    """Power-of-two capture length bucket, floored at 512."""
    return pow2_bucket(n, CAPTURE_BUCKET_MIN)


def env_viterbi_window() -> int:
    """ZIRIA_VITERBI_WINDOW: sliding-window decode length, 0 = off. An
    unparseable value degrades to 0 (off)."""
    try:
        return int(os.environ.get("ZIRIA_VITERBI_WINDOW", "0"))
    except ValueError:
        return 0


def env_viterbi_metric() -> str:
    """ZIRIA_VITERBI_METRIC: ACS metric dtype (default float32). An
    unknown metric raises."""
    md = os.environ.get("ZIRIA_VITERBI_METRIC") or "float32"
    if md not in VITERBI_METRICS:
        raise ValueError(
            f"ZIRIA_VITERBI_METRIC={md!r} is not one of "
            f"{VITERBI_METRICS}")
    return md


def env_viterbi_radix() -> int:
    """ZIRIA_VITERBI_RADIX: ACS radix (default 2). An unknown radix
    raises."""
    raw = os.environ.get("ZIRIA_VITERBI_RADIX") or "2"
    try:
        radix = int(raw)
    except ValueError:
        raise ValueError(
            f"ZIRIA_VITERBI_RADIX={raw!r} is not one of "
            f"{VITERBI_RADIXES}") from None
    if radix not in VITERBI_RADIXES:
        raise ValueError(
            f"ZIRIA_VITERBI_RADIX={radix!r} is not one of "
            f"{VITERBI_RADIXES}")
    return radix


def env_fused_demap() -> bool:
    """ZIRIA_FUSED_DEMAP (default off): run demap, deinterleave and
    depuncture inside the decode kernel."""
    return os.environ.get("ZIRIA_FUSED_DEMAP", "0") == "1"


def env_sco_track() -> bool:
    """ZIRIA_RX_SCO_TRACK (default off): pilot phase-ramp tracking for
    a sampling-clock offset."""
    return os.environ.get("ZIRIA_RX_SCO_TRACK", "0") == "1"
