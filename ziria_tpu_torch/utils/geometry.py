"""The default bucket rules of the receive path and the environment
readers of its decode knobs (counterpart of
ziria_tpu/utils/geometry.py: ``Geometry`` at its defaults, :166-192,
and ``env_fused_demap`` / ``env_sco_track``, :120-134)."""

from __future__ import annotations

import os

from ziria_tpu_torch.utils.dispatch import pow2_bucket

SYM_BUCKET_MIN = 4
CAPTURE_BUCKET_MIN = 512


def sym_bucket(n_sym: int) -> int:
    """Power-of-two DATA symbol bucket, floored at 4."""
    return pow2_bucket(n_sym, SYM_BUCKET_MIN)


def capture_bucket(n: int) -> int:
    """Power-of-two capture length bucket, floored at 512."""
    return pow2_bucket(n, CAPTURE_BUCKET_MIN)


def env_fused_demap() -> bool:
    """ZIRIA_FUSED_DEMAP (default off): run demap, deinterleave and
    depuncture inside the decode kernel."""
    return os.environ.get("ZIRIA_FUSED_DEMAP", "0") == "1"


def env_sco_track() -> bool:
    """ZIRIA_RX_SCO_TRACK (default off): pilot phase-ramp tracking for
    a sampling-clock offset."""
    return os.environ.get("ZIRIA_RX_SCO_TRACK", "0") == "1"
