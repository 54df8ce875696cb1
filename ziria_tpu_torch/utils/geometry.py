"""The bucket rules of the receive path, the environment readers of
its decode knobs and the :class:`Geometry` object that gathers every
tunable (counterpart of ziria_tpu/utils/geometry.py: the knobs' legal
values :63-65, the readers ``env_viterbi_window``,
``env_viterbi_metric``, ``env_viterbi_radix``, ``env_fused_demap`` and
``env_sco_track``, :80-134, ``env_trajectory_path`` :137, ``Geometry``
:153-280 with ``tuned`` :258, ``detect_device_kind`` :283 and
``latest_tuned_record`` :295).

The autotuner's winners live in the port's own record file,
``TUNED_BASENAME`` at the repo root (``ZIRIA_TORCH_TUNED`` names another
one), never in the reference's ``BENCH_TRAJECTORY.jsonl``."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from ziria_tpu_torch.utils.dispatch import pow2_bucket

#: valid Viterbi metric dtypes (ops/viterbi.METRIC_DTYPES aliases this)
VITERBI_METRICS = ("float32", "int16", "int8")
#: valid Viterbi ACS radixes (ops/viterbi.RADIXES aliases this)
VITERBI_RADIXES = (2, 4)

SYM_BUCKET_MIN = 4
CAPTURE_BUCKET_MIN = 512

#: the autotuner's record file, one JSON object a line, at the repo root
TUNED_BASENAME = "TORCH_TUNED.jsonl"


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


def env_trajectory_path() -> str:
    """The autotuner's record file: ZIRIA_TORCH_TUNED, else
    ``TUNED_BASENAME`` at the repo root next to this package."""
    p = os.environ.get("ZIRIA_TORCH_TUNED")
    if p:
        return p
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, TUNED_BASENAME)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Every tunable of the receive paths in one frozen, hashable value:
    the streaming window, the bucket floors, the detector parameters
    and the decode-mode knobs. The field defaults are the receivers'
    constants, so ``Geometry()`` builds the default receiver; a
    decode-mode knob of None means "read its environment default"
    (:meth:`resolve`)."""

    # streaming window geometry
    chunk_len: int = 1 << 13
    frame_len: int = 2048
    max_frames_per_chunk: int = 8         # K
    n_streams: int = 8                    # S, the fleet width
    # power-of-two bucket floors
    sym_bucket_min: int = SYM_BUCKET_MIN
    capture_bucket_min: int = CAPTURE_BUCKET_MIN
    bit_bucket_min: int = 128
    # detector parameters
    threshold: float = 0.75
    min_run: int = 33
    dead_zone: int = 320
    # decode-mode knobs; None = the environment default (resolve())
    viterbi_window: Optional[int] = None
    viterbi_metric: Optional[str] = None
    viterbi_radix: Optional[int] = None
    fused_demap: Optional[bool] = None
    sco_track: Optional[bool] = None

    def sym_bucket(self, n_sym: int) -> int:
        """Power-of-two DATA symbol bucket."""
        return pow2_bucket(n_sym, self.sym_bucket_min)

    def capture_bucket(self, n: int) -> int:
        """Power-of-two capture bucket."""
        return pow2_bucket(n, self.capture_bucket_min)

    def bit_bucket(self, n_bits: int) -> int:
        """Power-of-two PSDU bit bucket."""
        return pow2_bucket(n_bits, self.bit_bucket_min)

    def resolve(self) -> "Geometry":
        """Every None decode-mode knob replaced by its environment
        default; validates the metric and the radix."""
        vw, vm, vr = (self.viterbi_window, self.viterbi_metric,
                      self.viterbi_radix)
        if vm is not None and vm not in VITERBI_METRICS:
            raise ValueError(
                f"viterbi_metric {vm!r} is not one of {VITERBI_METRICS}")
        if vr is not None and int(vr) not in VITERBI_RADIXES:
            raise ValueError(
                f"viterbi_radix {vr!r} is not one of {VITERBI_RADIXES}")
        return dataclasses.replace(
            self,
            viterbi_window=env_viterbi_window() if vw is None else int(vw),
            viterbi_metric=env_viterbi_metric() if vm is None else vm,
            viterbi_radix=env_viterbi_radix() if vr is None else int(vr),
            fused_demap=(env_fused_demap() if self.fused_demap is None
                         else bool(self.fused_demap)),
            sco_track=(env_sco_track() if self.sco_track is None
                       else bool(self.sco_track)))

    def replace(self, **changes: Any) -> "Geometry":
        return dataclasses.replace(self, **changes)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Geometry":
        """Strict inverse of :meth:`as_dict`: unknown keys raise."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown Geometry field(s): {', '.join(unknown)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "Geometry":
        return cls.from_dict(json.loads(s))

    @classmethod
    def tuned(cls, device_kind: Optional[str] = None,
              path: Optional[str] = None) -> "Geometry":
        """The newest autotuner winner recorded for ``device_kind``
        (default: this process's card), or ``Geometry()`` when there is
        no record file, no matching record or one this build cannot
        parse. Never raises: a tuned geometry is an optimization."""
        try:
            if device_kind is None:
                device_kind = detect_device_kind()
            rec = latest_tuned_record(device_kind, path)
            if rec is None:
                return cls()
            return cls.from_dict(rec["geometry"])
        except Exception:
            return cls()


#: the shared default instance
DEFAULT = Geometry()


def detect_device_kind() -> Optional[str]:
    """``torch.cuda.get_device_name(0)``, or None without a card."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(0)
    except Exception:
        return None


def latest_tuned_record(device_kind: Optional[str],
                        path: Optional[str] = None) -> Optional[Dict]:
    """The newest ``stage=autotune`` record of the record file whose
    ``device_kind`` matches (None matches None: a file written where no
    card was named serves that same environment), or None."""
    p = path or env_trajectory_path()
    best = None
    try:
        with open(p, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict) \
                        or rec.get("stage") != "autotune" \
                        or "geometry" not in rec \
                        or rec.get("device_kind") != device_kind:
                    continue
                if best is None or rec.get("unix", 0) >= best.get(
                        "unix", 0):
                    best = rec
    except OSError:
        return None
    return best
