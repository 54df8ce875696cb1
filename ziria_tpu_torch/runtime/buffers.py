"""Typed stream I/O: the reference's buf_* family, host-side (port copy of
ziria_tpu/runtime/buffers.py, which imports no JAX).

Counterpart of `csrc/buf_bit.c` / `buf_numerics{8,16,32}.c` (SURVEY.md
§2.2): typed get/put of stream items in the reference's two file modes —
``dbg`` (human-readable comma-separated text) and ``bin`` (raw
little-endian) — plus ``dummy`` (discard / zeros) and ``memory``
(in-process arrays). Bit streams pack 8 bits per byte in bin mode
(LSB-first, padded up to a byte boundary — there is no length header,
same as the reference), one '0'/'1' character per item in dbg mode.

TPU-first difference: there is no per-item get/put hot path — the whole
stream is materialized as one numpy array at the host boundary and
shipped to the device in bulk (the device-side analogue of the
reference's buffers is the chunked scan in backend/execute.py).

Item types:

  bit        uint8 0/1 items        (packed in bin mode)
  int8/int16/int32                  little-endian in bin mode
  complex16  (2,) int16 re,im pairs (interleaved in both modes)
  complex32  (2,) int32 re,im pairs
  float32/float64                   '%g' text in dbg mode
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

_SCALAR_DTYPES = {
    "bit": np.uint8,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "float32": np.float32,
    "float64": np.float64,
}
_PAIR_DTYPES = {"complex16": np.int16, "complex32": np.int32}
ITEM_TYPES = tuple(_SCALAR_DTYPES) + tuple(_PAIR_DTYPES)


def _check_ty(ty: str) -> None:
    if ty not in ITEM_TYPES:
        raise ValueError(f"unknown item type {ty!r}; one of {ITEM_TYPES}")


def item_shape(ty: str) -> tuple:
    """Trailing (non-stream) shape of one item of type `ty`."""
    _check_ty(ty)
    return (2,) if ty in _PAIR_DTYPES else ()


# --------------------------------------------------------------------------
# dbg (text) mode
# --------------------------------------------------------------------------


def _parse_dbg(text: str, ty: str) -> np.ndarray:
    if ty == "bit":
        vals = [c for c in text if c in "01"]
        return np.array([int(c) for c in vals], np.uint8)
    base = _SCALAR_DTYPES.get(ty) or _PAIR_DTYPES[ty]
    toks = text.replace(",", " ").split()
    if np.issubdtype(base, np.floating):
        flat = np.array([float(t) for t in toks], base)
    else:
        flat = np.array([int(t) for t in toks], base)
    if ty in _PAIR_DTYPES:
        if flat.size % 2:
            raise ValueError(
                f"dbg {ty} stream has odd value count {flat.size} "
                f"(items are re,im pairs)")
        return flat.reshape(-1, 2)
    return flat


def _format_dbg(arr: np.ndarray, ty: str) -> str:
    if ty == "bit":
        return "".join("1" if v else "0" for v in arr.ravel())
    flat = arr.ravel()
    if ty in ("float32", "float64"):
        # repr-faithful digits so dbg text round-trips exactly
        prec = ".9g" if flat.dtype == np.float32 else ".17g"
        return ",".join(f"{float(v):{prec}}" for v in flat)
    # integer item type: round float pipeline outputs, don't truncate
    if np.issubdtype(flat.dtype, np.floating):
        flat = np.rint(flat)
    return ",".join(str(int(round(float(v)))) for v in flat)


# --------------------------------------------------------------------------
# bin mode
# --------------------------------------------------------------------------


def _parse_bin(data: bytes, ty: str) -> np.ndarray:
    if ty == "bit":
        packed = np.frombuffer(data, np.uint8)
        return np.unpackbits(packed, bitorder="little")
    base = _SCALAR_DTYPES.get(ty) or _PAIR_DTYPES[ty]
    flat = np.frombuffer(data, np.dtype(base).newbyteorder("<"))
    flat = flat.astype(base)
    if ty in _PAIR_DTYPES:
        return flat.reshape(-1, 2)
    return flat


def _format_bin(arr: np.ndarray, ty: str) -> bytes:
    if ty == "bit":
        bits = np.asarray(arr, np.uint8).ravel()
        return np.packbits(bits, bitorder="little").tobytes()
    base = _SCALAR_DTYPES.get(ty) or _PAIR_DTYPES[ty]
    a = np.asarray(arr)
    if (np.issubdtype(a.dtype, np.floating)
            and np.issubdtype(np.dtype(base), np.integer)):
        a = np.rint(a)  # round float pipeline outputs, don't truncate
    return np.asarray(a, base).astype(
        np.dtype(base).newbyteorder("<")).tobytes()


# --------------------------------------------------------------------------
# Spec + top-level read/write
# --------------------------------------------------------------------------


@dataclass
class StreamSpec:
    """One side of the driver's I/O, in reference params style:
    --input=file --input-file-name=... --input-file-mode=dbg|bin."""

    kind: str = "file"          # file | dummy | memory
    ty: str = "int32"
    path: Optional[str] = None
    mode: str = "dbg"           # dbg | bin
    data: Optional[np.ndarray] = None   # memory kind
    dummy_items: int = 0        # dummy input length

    def __post_init__(self):
        _check_ty(self.ty)
        if self.kind not in ("file", "dummy", "memory"):
            raise ValueError(f"unknown stream kind {self.kind!r}")
        if self.mode not in ("dbg", "bin"):
            raise ValueError(f"unknown file mode {self.mode!r}")
        if self.kind == "file" and not self.path:
            raise ValueError("file stream needs a path")


def read_stream(spec: StreamSpec) -> np.ndarray:
    """Read the whole input stream as (items, *item_shape)."""
    if spec.kind == "memory":
        if spec.data is None:
            raise ValueError("memory input spec has no data")
        return np.asarray(spec.data)
    if spec.kind == "dummy":
        return np.zeros((spec.dummy_items,) + item_shape(spec.ty),
                        _SCALAR_DTYPES.get(spec.ty)
                        or _PAIR_DTYPES[spec.ty])
    if spec.mode == "dbg":
        with open(spec.path, "r") as fh:
            return _parse_dbg(fh.read(), spec.ty)
    with open(spec.path, "rb") as fh:
        return _parse_bin(fh.read(), spec.ty)


def write_stream(spec: StreamSpec, arr: np.ndarray) -> Optional[np.ndarray]:
    """Write the whole output stream; returns the array for kind=memory."""
    arr = np.asarray(arr)
    if spec.kind == "dummy":
        return None
    if spec.kind == "memory":
        return arr
    if spec.mode == "dbg":
        with open(spec.path, "w") as fh:
            fh.write(_format_dbg(arr, spec.ty))
    else:
        with open(spec.path, "wb") as fh:
            fh.write(_format_bin(arr, spec.ty))
    return None
