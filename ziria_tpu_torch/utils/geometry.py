"""The default bucket rules of the receive path (counterpart of
ziria_tpu/utils/geometry.py:166-192, ``Geometry`` at its defaults)."""

from __future__ import annotations

from ziria_tpu_torch.utils.dispatch import pow2_bucket

SYM_BUCKET_MIN = 4
CAPTURE_BUCKET_MIN = 512


def sym_bucket(n_sym: int) -> int:
    """Power-of-two DATA symbol bucket, floored at 4."""
    return pow2_bucket(n_sym, SYM_BUCKET_MIN)


def capture_bucket(n: int) -> int:
    """Power-of-two capture length bucket, floored at 512."""
    return pow2_bucket(n, CAPTURE_BUCKET_MIN)
