"""Staged evaluator for the surface expression language (counterpart
of ziria_tpu/frontend/eval.py).

It executes expression and statement ASTs over three kinds of value:
Python scalars (static), numpy values (host) and torch tensors
(device). On the host it is the interpreter, the oracle. Inside a
*device block* -- a hybrid do-block placed on the card
(backend/hybrid.py), a jit firing function under ``torch.func.vmap``
(backend/lower.py) or a stateful stage's firing -- it runs the very
same AST eagerly on tensors. Eager torch has no trace: where the
reference stages a loop into ``lax.fori_loop``, the port first tries
the same two rewrites (the lane-vector lowering ``_vectorized_for``,
then GF(2) compression ``gf2.gf2_for``) and otherwise runs a plain
Python loop over device tensors, counted in ``COUNTS``. A scalar
condition on a device tensor syncs with ``bool()`` (the interpreter's
exact semantics, counted too), except under vmap, where a batched
condition takes the where-merge ``_staged_if`` as the reference's
traced one does, and a batched ``while`` or loop bound raises
``DeviceControlError`` (backend/lower.py then runs the firings one at
a time).

Value representation / dtype policy:

  bit        Python int 0/1 (static) or uint8
  bool       Python bool or bool
  int{8,16,32,64}, int   integer scalars. Arithmetic follows C:
             int8/int16 operands promote to int32 before binops
             (_promote_narrow_np), results narrow back to the declared
             width only at assignment/cast; int32/int64 wrap at their
             own width like C int/long long. *Literals and untyped lets
             stay Python ints* so array lengths, take counts and loop
             bounds remain static under tracing (unbounded until
             assigned — diverges from C only past 2^63).
  double     float32 (the reference's dtype policy; the golden-file
             differ absorbs the precision delta)
  complex{16,32}, complex  complex64; `.re`/`.im` field access
  arr[n] t   numpy array or tensor; mutation is functional (a new
             array per update)
  struct     dict {field: value} tagged with "__struct__"

Static Python scalars flow through arithmetic unchanged (int+int=int),
which is what keeps `takes (n*2)` and `for i in [0, n]` compile-time
constants; anything touching a tensor promotes to torch. Numpy values
meeting a tensor convert as the reference's ``jnp.asarray`` does with
x64 off (64-bit floats, complexes and ints narrow to 32 bits), and
Python scalars stay weakly typed (they take the other operand's dtype
where their kind allows). Division and remainder follow C on the
device too (``torch.div(..., rounding_mode="trunc")``, ``torch.fmod``);
a dynamic index clamps into range on reads and drops out-of-range
writes, and a dynamic slice start clamps, as ``lax`` does.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ziria_tpu_torch.frontend import ast as A


class ZiriaRuntimeError(RuntimeError):
    pass


class NotStatic(Exception):
    """Raised by the static-evaluation entry when a value is runtime."""


class DeviceControlError(ZiriaRuntimeError):
    """Data-dependent control on a batched value under ``vmap``: a
    ``while`` condition, a loop bound or a sync that differs per
    firing. backend/lower.py runs such a stage one firing at a time."""


def _rt_err(loc: Tuple[int, int], msg: str) -> ZiriaRuntimeError:
    return ZiriaRuntimeError(f"{loc[0]}:{loc[1]}: {msg}")


# --------------------------------------------------------------------------
# Types → dtypes / casts
# --------------------------------------------------------------------------

_INT_DTYPES = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
               "int64": np.int64, "int": np.int32}
_CPLX = ("complex", "complex16", "complex32")


# --------------------------------------------------------------------------
# Device mode, counters and the torch value helpers
# --------------------------------------------------------------------------

class _ThreadMode(threading.local):
    """The evaluator's device state, one per thread (the frame threads
    of backend/framebatch.run_many run device blocks side by side):
    kind None (host), "block" (an eager device block) or "vmap" (a jit
    firing function or a chunk-machine iteration under
    torch.func.vmap); "lanes" counts the lane-vector loop passes
    running (a loop nested in one runs as a plain loop over the
    lanes)."""

    def __init__(self):
        self.d = {"kind": None, "device": None, "lanes": 0}

    def __getitem__(self, k):
        return self.d[k]

    def __setitem__(self, k, v):
        self.d[k] = v


_MODE = _ThreadMode()

#: a list while a chunk machine captures a CUDA graph
#: (backend/chunked.py), else None: host values then reach the card by
#: a fill kernel (scalars) or a copy from pinned memory (arrays), which
#: a capture records, and the pinned buffers are kept here for the
#: graph's lifetime. "guard" is set for the whole of a chunk-machine
#: step, on any device: a host read of a device value then raises
_CAPTURE = {"keep": None, "guard": False}

#: per-run counters: iterations of plain device loops (a loop that was
#: neither lane-vectorized nor GF(2)-compressed: one launch per op per
#: iteration) and host syncs on device values (bool()/item())
COUNTS = {"device_loop_iters": 0, "syncs": 0}

#: a statement loop whose iterations each run an inner reduction over
#: their own locals runs as one lane-vector pass (_vector_plan); False
#: runs it as the plain device loop (scripts/lane_pass.py times both)
NESTED_LANE_PASS = True


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@contextlib.contextmanager
def device_mode(kind: str, device):
    """Evaluate the body as a device block of `kind` ("block" or
    "vmap") on `device`; nests, restoring the outer mode after."""
    prev = dict(_MODE.d)
    _MODE["kind"], _MODE["device"] = kind, torch.device(device)
    try:
        yield
    finally:
        _MODE.d = prev


_NP_TO_T = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
            np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
            np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
            np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64,
            np.dtype(np.complex64): torch.complex64,
            np.dtype(np.complex128): torch.complex128}
_T_TO_NP = {v: k for k, v in _NP_TO_T.items()}
# jnp.asarray with x64 off: host 64-bit values narrow on the way in
_CANON = {np.dtype(np.float64): torch.float32,
          np.dtype(np.complex128): torch.complex64,
          np.dtype(np.int64): torch.int32,
          np.dtype(np.uint16): torch.int32,
          np.dtype(np.uint32): torch.int64,
          np.dtype(np.uint64): torch.int64}
_NARROW = (torch.int8, torch.int16, torch.uint8)


def t_dtype(dt) -> torch.dtype:
    """torch dtype of a numpy dtype (or torch dtype)."""
    if isinstance(dt, torch.dtype):
        return dt
    return _NP_TO_T[np.dtype(dt)]


def np_dtype(dt) -> np.dtype:
    """numpy dtype of a torch dtype (or numpy dtype)."""
    if isinstance(dt, torch.dtype):
        return _T_TO_NP[dt]
    return np.dtype(dt)


def _dev(*vs):
    """Device of the first tensor among `vs`, else the device block's,
    else the CPU."""
    for v in vs:
        if isinstance(v, torch.Tensor):
            return v.device
    return _MODE["device"] or torch.device("cpu")


def _py_dtype(v, strong=None) -> torch.dtype:
    """dtype of a Python scalar meeting `strong`: jnp's weak typing (an
    int takes any numeric dtype, a float any floating or complex one)."""
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, int):
        return strong if strong is not None and strong != torch.bool \
            else torch.int32
    if isinstance(v, float):
        return strong if strong is not None and (
            strong.is_floating_point or strong.is_complex) \
            else torch.float32
    return strong if strong is not None and strong.is_complex \
        else torch.complex64


def _t(v, device=None, dtype=None) -> torch.Tensor:
    """Any value as a tensor on `device` (default: `_dev(v)`): tensors
    pass, numpy converts at the canonical 32-bit dtypes, Python scalars
    take their weak dtype."""
    if isinstance(v, torch.Tensor):
        if device is not None and v.device != torch.device(device) \
                and v.dim() > 0:
            v = v.to(device)
        return v if dtype is None else v.to(dtype)
    dev = torch.device(device if device is not None else _dev())
    capturing = _CAPTURE["keep"] is not None and dev.type == "cuda"
    if isinstance(v, (bool, int, float, complex)) and not hasattr(
            v, "dtype"):
        if capturing:
            return torch.full((), v, dtype=dtype or _py_dtype(v),
                              device=dev)
        return torch.tensor(v, dtype=dtype or _py_dtype(v), device=dev)
    a = np.asarray(v)
    if a.dtype == object:
        raise ZiriaRuntimeError(f"cannot stage a value of type "
                                f"{type(v).__name__} on the device")
    tdt = _CANON.get(a.dtype) or _NP_TO_T[a.dtype]
    # asarray(order="C"), not ascontiguousarray: that one makes 0-d 1-d
    host = torch.from_numpy(np.asarray(a, order="C"))
    if capturing:
        host = host.pin_memory()
        _CAPTURE["keep"].append(host)
        out = host.to(device=dev, non_blocking=True).to(tdt)
    else:
        out = host.to(device=dev, dtype=tdt)
    return out if dtype is None else out.to(dtype)


def _common_dtype(vals) -> torch.dtype:
    """The dtype jnp would give `vals` together: tensors and numpy
    values are strong, Python scalars weak."""
    strong = None
    for v in vals:
        if isinstance(v, torch.Tensor):
            dt = v.dtype
        elif hasattr(v, "dtype"):
            a = np.asarray(v)
            dt = _CANON.get(a.dtype) or _NP_TO_T[a.dtype]
        else:
            continue
        strong = dt if strong is None else torch.promote_types(strong, dt)
    out = strong
    for v in vals:
        if not hasattr(v, "dtype") and not isinstance(v, torch.Tensor):
            dt = _py_dtype(v, strong)
            out = dt if out is None else torch.promote_types(out, dt)
    return out if out is not None else torch.float32


def _ts(vals, device=None):
    """`vals` as tensors of one common dtype on one device."""
    dev = device if device is not None else _dev(*vals)
    dt = _common_dtype(vals)
    return [_t(v, dev, dt) for v in vals]


def _is_batched(v) -> bool:
    """True for a tensor batched by an enclosing torch.func.vmap."""
    return isinstance(v, torch.Tensor) and \
        torch._C._functorch.is_batchedtensor(v)


def _sync_bool(v, loc=(0, 0)) -> bool:
    """bool() of a device value, counted as a sync; a batched value
    under vmap is data-dependent control and raises."""
    if isinstance(v, torch.Tensor):
        if _is_batched(v):
            raise DeviceControlError(
                f"{loc[0]}:{loc[1]}: control flow depends on a value "
                f"that differs per firing (under vmap)")
        _no_host_read(loc)
        COUNTS["syncs"] += 1
        return bool(v)
    return bool(v)


def _no_host_read(loc=(0, 0)) -> None:
    """A host read of a device value inside a chunk-machine step (a
    sync a CUDA graph cannot record) is a control-flow shape the step
    does not support: raise as data-dependent control does."""
    if _CAPTURE["guard"]:
        raise DeviceControlError(
            f"{loc[0]}:{loc[1]}: a chunk-machine step reads a device "
            f"value on the host")


def _size(v) -> int:
    return v.numel() if isinstance(v, torch.Tensor) else int(np.size(v))


def _to_host(v):
    """A 0-d tensor's value as numpy (a sync), else `v`."""
    if isinstance(v, torch.Tensor):
        _no_host_read()
        COUNTS["syncs"] += 1
        return v.detach().cpu().numpy()
    return v


def _gather(arr, i):
    """arr[i] for a dynamic (tensor or host) index, scalar or lane
    vector: a negative index wraps once and the result clamps into
    range, as a jnp gather does."""
    arr = _t(arr, _dev(arr, i))
    n = arr.shape[0]
    it = _t(i, arr.device).to(torch.int64)
    it = torch.where(it < 0, it + n, it).clamp(0, n - 1)
    return arr[it]


def _scatter(old, i, v):
    """old.at[i].set(v) for a dynamic index (scalar or lane vector): a
    negative index wraps once, out-of-range writes drop (jnp's default
    scatter mode). Out of place, so it works under vmap."""
    dev = _dev(old, i, v)
    old = _t(old, dev)
    n = old.shape[0]
    it = _t(i, dev).to(torch.int64)
    it = torch.where(it < 0, it + n, it)
    it = torch.where((it >= 0) & (it < n), it, n)     # n: the drop row
    vv = _t(v, dev)
    if vv.is_complex() and not old.is_complex():
        vv = vv.real
    vv = vv.to(old.dtype)
    pad = torch.cat([old, old[:1]])
    shape = tuple(it.shape) + tuple(old.shape[1:])
    out = torch.index_put(pad, (it,), torch.broadcast_to(vv, shape))
    return out[:n]


def _update_at(old, i: int, v):
    """old with element i replaced by v (a static index), out of
    place: a concatenation, so it also works under vmap."""
    dev = _dev(old, v)
    old = _t(old, dev)
    vv = _t(v, dev)
    if vv.is_complex() and not old.is_complex():
        vv = vv.real
    vv = torch.broadcast_to(vv.to(old.dtype), tuple(old.shape[1:]))
    return torch.cat([old[:i], vv[None], old[i + 1:]])


def _slice_start(i, N: int, n: int):
    """lax's dynamic-slice start: a negative start counts once from the
    end, then the start clamps to [0, N - n]."""
    if not isinstance(i, torch.Tensor):
        s = int(i)
        s = s + N if s < 0 else s
        return min(max(s, 0), N - n)
    s = i.to(torch.int64)
    return torch.where(s < 0, s + N, s).clamp(0, N - n)


def _dyn_slice(arr, i, n: int):
    """lax.dynamic_slice_in_dim (start as ``_slice_start``)."""
    arr = _t(arr, _dev(arr, i))
    N = arr.shape[0]
    if not isinstance(i, torch.Tensor):
        s = _slice_start(i, N, n)
        return arr[s:s + n]
    s = _slice_start(_t(i, arr.device), N, n)
    return arr[s + torch.arange(n, device=arr.device)]


def _dyn_update_slice(old, vv, i):
    """lax.dynamic_update_slice_in_dim on axis 0 (start as
    ``_slice_start``). Out of place."""
    old = _t(old, _dev(old, vv, i))
    N, m = old.shape[0], vv.shape[0]
    s = _slice_start(i, N, m)
    if not isinstance(s, torch.Tensor):
        return torch.cat([old[:s], vv.to(old.dtype), old[s + m:]])
    idx = s + torch.arange(m, device=old.device)
    return torch.index_put(old, (idx,), vv.to(old.dtype))


def _real(v):
    if isinstance(v, torch.Tensor):
        return v.real if v.is_complex() else v
    return np.real(v)


def _imag(v):
    if isinstance(v, torch.Tensor):
        return v.imag if v.is_complex() else torch.zeros_like(v)
    return np.imag(v)


def _where(c, a, b):
    """jnp.where over any mix of values (tensors, numpy, scalars)."""
    dev = _dev(c, a, b)
    ta, tb = _ts([a, b], dev)
    return torch.where(_t(c, dev).to(torch.bool), ta, tb)


_NP_CONCRETE = (int, float, bool, complex, np.ndarray, np.generic)


def _np_ok(*vs) -> bool:
    """True when every value is a plain Python/numpy value.

    Concrete evaluation (the interpreter backend) then runs on numpy,
    which matters because the streaming oracle executes per-sample
    loops. Anything else (tensors of a device block or of the jit
    backend's vmap) takes the torch path. numpy>=2 NEP-50 promotion
    matches jnp's weak typing for scalar-array mixes.
    """
    for v in vs:
        if not isinstance(v, _NP_CONCRETE):
            return False
    return True


def is_static(v: Any) -> bool:
    return isinstance(v, (int, float, bool, complex)) and not hasattr(
        v, "dtype")


def _is_traced(*vs) -> bool:
    """True inside a device block when any value is a tensor: the
    port's counterpart of the reference's "is a jax Tracer". It picks
    the device paths (loop rewrites, staged while); a scalar ``if``
    still syncs outside vmap (exec_stmt)."""
    if _MODE["kind"] is None:
        return False
    return any(isinstance(v, torch.Tensor) for v in vs)


def base_dtype(name: str):
    """numpy dtype of a base type (``t_dtype`` gives the torch one)."""
    if name == "bit":
        return np.dtype(np.uint8)
    if name == "bool":
        return np.dtype(np.bool_)
    if name in _INT_DTYPES:
        return np.dtype(_INT_DTYPES[name])
    if name == "double":
        return np.dtype(np.float32)
    if name in _CPLX:
        return np.dtype(np.complex64)
    raise ValueError(f"no dtype for base type {name!r}")


@dataclass
class StructDef:
    name: str
    fields: Tuple[Tuple[str, A.Ty], ...]


def fx_is_pair(v: Any) -> bool:
    """Is `v` plausibly a fixed-point complex16 value (signed-integer
    IQ-pair array)? A shape heuristic: under the opt-in policy a
    (..., 2) signed-int array is treated as complex16 by * and == when
    no declared type says otherwise (EBin consults declared var types
    first — see _fx_ty_hint). Unsigned arrays (bit streams) never
    match."""
    return (hasattr(v, "dtype") and v.ndim >= 1 and v.shape[-1] == 2
            and np.issubdtype(np_dtype(v.dtype), np.signedinteger))


def fx_wrap16(v):
    """Wrap components to int16 range, keep int32 storage (the C shorts
    store-narrowing, without losing the promoted width for the next
    operation). Floats wrap MODULARLY via fmod in the float domain —
    exact for every representable float (fmod is exact, and the result
    is an integer < 2^17, exactly representable), identical on numpy
    and torch, and needing no int64 (the reference's reason: JAX
    truncates it to int32 with x64 off). astype(int16) on out-of-range
    floats is implementation-defined, which would break the interp ==
    jit invariant."""
    if not _np_ok(v):
        x = _t(v)
        if x.is_floating_point():
            r = torch.fmod(torch.round(x), 65536.0)
            r = torch.where(r >= 32768.0, r - 65536.0, r)
            r = torch.where(r < -32768.0, r + 65536.0, r)
            return r.to(torch.int32)
        return x.to(torch.int16).to(torch.int32)
    x = np.asarray(v)
    if not np.issubdtype(np.dtype(x.dtype), np.integer):
        r = np.fmod(np.round(x), 65536.0)      # (-65536, 65536), exact
        r = np.where(r >= 32768.0, r - 65536.0, r)
        r = np.where(r < -32768.0, r + 65536.0, r)
        return r.astype(np.int32)
    return x.astype(np.int16).astype(np.int32)


def fx_pair(re, im) -> Any:
    """Build a fixed-point complex16 from components (wrapped)."""
    if _np_ok(re, im):
        return np.stack([fx_wrap16(re), fx_wrap16(im)], axis=-1)
    return torch.stack(_ts([fx_wrap16(re), fx_wrap16(im)]), dim=-1)


def _fx_cast(v: Any) -> Any:
    """Coerce any complex-ish value to a fixed-point IQ pair."""
    if is_static(v):
        c = complex(v)
        return fx_pair(np.int64(round(c.real)), np.int64(round(c.imag)))
    if fx_is_pair(v):
        return fx_wrap16(v)
    a = np.asarray(v) if _np_ok(v) else _t(v)
    if np_dtype(a.dtype).kind == "c":
        return fx_pair(_real(a), _imag(a))
    if a.ndim >= 1 and a.shape[-1] == 2:
        return fx_pair(a[..., 0], a[..., 1])   # float pairs round+wrap
    raise ZiriaRuntimeError(
        f"cannot cast value of shape {np.shape(v)} to fixed-point "
        f"complex16 (expected complex or (..., 2) pair)")


def cast_value(ty: Optional[A.Ty], v: Any, structs: Dict[str, StructDef],
               static_eval: Optional[Callable] = None,
               fxp: bool = False) -> Any:
    """Cast `v` to surface type `ty` (None = leave as-is). `fxp` is the
    Ctx.fxp_complex16 policy: complex16 becomes an int32 IQ pair."""
    if ty is None:
        return v
    if isinstance(ty, A.TBase):
        if fxp and ty.name == "complex16":
            return _fx_cast(v)
        if ty.name == "bit" and is_static(v):
            return int(v) & 1
        if ty.name in ("int", "int8", "int16", "int32", "int64") \
                and is_static(v):
            # static ints stay static, but wrap to the declared width
            w = np.dtype(_INT_DTYPES[ty.name]).itemsize * 8
            x = int(v) & ((1 << w) - 1)
            return x - (1 << w) if x >= (1 << (w - 1)) else x
        if ty.name == "bool" and is_static(v):
            return bool(v)
        if ty.name == "double" and is_static(v):
            return float(v)
        if ty.name in _CPLX and is_static(v):
            return complex(v)
        dt = base_dtype(ty.name)
        if _np_ok(v):
            if ty.name == "bit":
                return np.asarray(v).astype(np.uint8) & np.uint8(1)
            if ty.name in _CPLX and fx_is_pair(v):
                # fx pair -> float complex (the f32 interop cast)
                a = np.asarray(v, np.float32)
                return (a[..., 0] + 1j * a[..., 1]).astype(dt)
            return np.asarray(v).astype(dt)
        x = _t(v)
        if ty.name == "bit":
            return _cast_t(x, torch.uint8) & 1
        if ty.name in _CPLX and fx_is_pair(x):
            x = x.to(torch.float32)
            return torch.complex(x[..., 0], x[..., 1])
        return _cast_t(x, t_dtype(dt))
    if isinstance(ty, A.TArr):
        if fxp and isinstance(ty.elem, A.TBase) \
                and ty.elem.name == "complex16":
            arr = _fx_cast(v)
        else:
            arr = np.asarray(v) if _np_ok(v) else _t(v)
            edt = base_dtype(ty.elem.name) \
                if isinstance(ty.elem, A.TBase) else None
            if edt is not None and np_dtype(arr.dtype) != edt:
                arr = arr.astype(edt) if isinstance(arr, np.ndarray) \
                    else _cast_t(arr, t_dtype(edt))
        if ty.n is not None and static_eval is not None:
            n = static_eval(ty.n)
            if int(arr.shape[0]) != int(n):
                raise ZiriaRuntimeError(
                    f"array of declared length {n} initialized with "
                    f"length {arr.shape[0]}")
        return arr
    if isinstance(ty, A.TStruct):
        sd = structs.get(ty.name)
        if sd is None:
            raise ZiriaRuntimeError(f"unknown struct type {ty.name!r}")
        if not isinstance(v, dict):
            raise ZiriaRuntimeError(
                f"struct {ty.name} initialized with non-struct value")
        out = {"__struct__": sd.name}
        for fn, fty in sd.fields:
            if fn not in v:
                raise ZiriaRuntimeError(f"struct {sd.name} missing "
                                        f"field {fn!r}")
            out[fn] = cast_value(fty, v[fn], structs, static_eval)
        return out
    raise ZiriaRuntimeError(f"cannot cast to {ty}")


def _cast_t(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A tensor cast with numpy's astype rules: complex to real keeps
    the real part."""
    if x.is_complex() and not dt.is_complex:
        x = x.real
    return x.to(dt)


def zero_value(ty: A.Ty, structs: Dict[str, StructDef],
               static_eval: Callable, fxp: bool = False) -> Any:
    if isinstance(ty, A.TBase):
        if fxp and ty.name == "complex16":
            return np.zeros(2, np.int32)
        if ty.name == "bit":
            return 0
        if ty.name in _INT_DTYPES:
            return 0
        if ty.name == "bool":
            return False
        if ty.name == "double":
            return 0.0
        if ty.name in _CPLX:
            return 0j
        raise ZiriaRuntimeError(f"no zero value for {ty.name}")
    if isinstance(ty, A.TArr):
        if ty.n is None:
            raise ZiriaRuntimeError(
                "length-polymorphic array needs an initializer")
        # numpy zeros: concrete evaluation stays in numpy; in a device
        # block these are initial constants that move to the device on
        # their first assignment from a tensor
        n = int(static_eval(ty.n))
        if fxp and isinstance(ty.elem, A.TBase) \
                and ty.elem.name == "complex16":
            return np.zeros((n, 2), np.int32)
        if isinstance(ty.elem, A.TBase):
            return np.zeros((n,), base_dtype(ty.elem.name))
        inner = zero_value(ty.elem, structs, static_eval, fxp)
        return np.zeros((n,) + tuple(np.shape(inner)),
                        getattr(inner, "dtype", np.float32))
    if isinstance(ty, A.TStruct):
        sd = structs[ty.name]
        return {"__struct__": sd.name,
                **{fn: zero_value(fty, structs, static_eval, fxp)
                   for fn, fty in sd.fields}}
    raise ZiriaRuntimeError(f"no zero value for {ty}")


# --------------------------------------------------------------------------
# Scopes
# --------------------------------------------------------------------------


@dataclass
class Cell:
    value: Any
    ty: Optional[A.Ty]
    mutable: bool


class Scope:
    """Chained lexical scope over Cells; supports snapshot/merge for
    staging dynamic `if` statements."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.cells: Dict[str, Cell] = {}
        self.parent = parent

    def child(self) -> "Scope":
        return Scope(self)

    def declare(self, name: str, value: Any, ty: Optional[A.Ty] = None,
                mutable: bool = False) -> None:
        self.cells[name] = Cell(value, ty, mutable)

    def find(self, name: str) -> Optional[Cell]:
        # recurse through parent.find (not a cells-walk) so subclasses
        # (elab.RuntimeScope) can interpose env-backed lookups mid-chain
        c = self.cells.get(name)
        if c is not None:
            return c
        return self.parent.find(name) if self.parent is not None else None

    def lookup(self, name: str, loc=(0, 0)) -> Any:
        c = self.find(name)
        if c is None:
            raise _rt_err(loc, f"unbound variable {name!r}")
        return c.value

    def assign(self, name: str, value: Any, ctx: "Ctx", loc=(0, 0)) -> None:
        # delegate up the chain so subclasses (RuntimeScope) can intercept
        # at their own level — a find()-based set would write to temporary
        # view cells and silently drop the store
        if name in self.cells:
            c = self.cells[name]
            if not c.mutable:
                raise _rt_err(loc, f"assignment to immutable binding "
                                   f"{name!r} (declare it with `var`)")
            c.value = cast_value(c.ty, value, ctx.structs,
                                 lambda x: ctx.static_eval(x, self),
                                 fxp=ctx.fxp_complex16) \
                if c.ty is not None else value
            return
        if self.parent is not None:
            return self.parent.assign(name, value, ctx, loc)
        raise _rt_err(loc, f"assignment to unbound variable {name!r}")

    def own_mutable_cells(self) -> List[Tuple[str, Any]]:
        return [(n, c) for n, c in self.cells.items() if c.mutable]

    def mutable_cells(self) -> List[Any]:
        return [c for _, c in self.mutable_cells_named()]

    def mutable_cells_named(self) -> List[Tuple[str, Any]]:
        out, s, seen = [], self, set()
        while s is not None:
            for name, c in s.own_mutable_cells():
                if name not in seen:
                    seen.add(name)
                    out.append((name, c))
            s = s.parent
        return out


# --------------------------------------------------------------------------
# Evaluation context
# --------------------------------------------------------------------------


@dataclass
class FunDef:
    decl: A.DFun
    closure: Scope           # scope the fun was defined in


@dataclass
class Ctx:
    funs: Dict[str, FunDef] = field(default_factory=dict)
    exts: Dict[str, Callable] = field(default_factory=dict)
    structs: Dict[str, StructDef] = field(default_factory=dict)
    on_print: Callable[[str], None] = print
    # opt-in int16 fixed-point complex16 policy (SURVEY.md §7 hard-part
    # (b)): complex16 values are (..., 2) int32 IQ pairs — the same
    # pair-last layout ops/cplx.py uses for f32 — with C shorts
    # semantics (components promote to int32 in arithmetic, wrap to
    # int16 at assignment/cast). See fx_* helpers below.
    fxp_complex16: bool = False
    # declared ext signatures (filled by the elaborator) — under the
    # fxp policy, complex-typed ext params convert pair -> complex64 at
    # the call boundary and complex16 returns requantize, so f32 bricks
    # like v_fft keep their documented f32 interior
    ext_sigs: Dict[str, Any] = field(default_factory=dict)
    # per-node memo for _fx_ty_hint (declared types are static per
    # program point; the hint walk must not run per stream item in the
    # interpreter hot loop)
    fx_hints: Dict[int, Any] = field(default_factory=dict)
    # AutoLUT inference (frontend/lutinfer.py, the reference's
    # LUTAnalysis role): when `autolut` is set (CLI --autolut), calls to
    # pure small-bit-width funs with device arguments become table
    # gathers; lut_specs memoizes per-fun verdicts and lut_tables the
    # synthesized tables (device constants)
    autolut: bool = False
    lut_specs: Dict[str, Any] = field(default_factory=dict)
    lut_tables: Dict[str, Any] = field(default_factory=dict)

    def static_eval(self, e: A.Expr, scope: Optional[Scope] = None) -> Any:
        """Evaluate `e` and require a static Python value (array lengths,
        take counts, loop bounds)."""
        v = eval_expr(e, scope or Scope(), self)
        if hasattr(v, "dtype") and tuple(getattr(v, "shape", (1,))) == ():
            if _is_batched(v):
                raise NotStatic(f"{e.loc[0]}:{e.loc[1]}: value differs "
                                f"per firing")
            if isinstance(v, torch.Tensor):
                COUNTS["syncs"] += 1
            try:
                v = v.item()
            except Exception:
                raise NotStatic(f"{e.loc[0]}:{e.loc[1]}: value is not "
                                f"compile-time static")
        if not is_static(v):
            raise NotStatic(f"{e.loc[0]}:{e.loc[1]}: value is not "
                            f"compile-time static")
        return v


# --------------------------------------------------------------------------
# Operators
# --------------------------------------------------------------------------


def _trunc_div(a, b):
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# module-level dispatch tables: _binop runs in the interpreter's
# per-sample hot loop; rebuilding dict literals per call is measurable
_NP_OPS = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "**": np.power,
    "<<": np.left_shift, ">>": np.right_shift,
    "<": np.less, "<=": np.less_equal, ">": np.greater,
    ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal,
}
_NP_BOOL_OPS = {"&": np.logical_and, "|": np.logical_or,
                "^": np.logical_xor}
_NP_BIT_OPS = {"&": np.bitwise_and, "|": np.bitwise_or,
               "^": np.bitwise_xor}


# C's usual arithmetic conversions apply to COMPARISONS too: without
# them `bit > -1` or `int8 == 256` silently disagree between the
# numpy path (strong int64 scalars) and the traced path (weak int32
# demoting to the narrow dtype)
_ARITH_PROMOTE = frozenset(("+", "-", "*", "/", "%", "**", "<<", ">>",
                            "&", "|", "^",
                            "<", "<=", ">", ">=", "==", "!="))


def _promote_narrow_np(x: np.ndarray) -> np.ndarray:
    """C integer promotion: int8/int16 — and the UNSIGNED narrows,
    uint8 (the `bit` type) / uint16 — widen to int32 before arithmetic,
    so mid-expression results never wrap at the narrow width (C
    semantics; ADVICE r1 medium). Narrowing back to the declared width
    happens at assignment/cast via cast_value — exactly where C
    truncates. int32/int64 wrap at their own width (= C int / long
    long); static Python ints are unbounded until assigned, which
    diverges from C only past 2^63.

    uint8 matters beyond C-pedantry: without it the two backends
    DISAGREE — `256 * some_bit` is 256 or 0 depending on path, because
    np.asarray(256) is a strong int64 scalar while jnp.asarray(256) is
    a weak int32 that defers to uint8 (found decoding a 1000-byte
    frame: the SIGNAL length's bit-8/9 terms vanished under jit)."""
    if x.dtype in (np.int8, np.int16, np.uint8, np.uint16):
        return x.astype(np.int32)
    return x


def _fx_split(v, loc=(0, 0)):
    """(re, im) integer components of a fixed-point operand; integer
    real scalars/arrays get im = 0. Fractional real operands are an
    ERROR, not a silent round — scaling a fixed-point value by 0.5
    must be written as an explicit shift/Q15 op (the same rule C
    programmers live by)."""
    if fx_is_pair(v):
        return v[..., 0], v[..., 1]
    if is_static(v):
        c = complex(v)
        if c.real != int(c.real) or c.imag != int(c.imag):
            raise _rt_err(loc, f"cannot mix fixed-point complex16 with "
                               f"the fractional value {v!r}; scale with "
                               f"integer arithmetic, shifts, or the Q15 "
                               f"ext helpers")
        return int(c.real), int(c.imag)
    if not _np_ok(v):
        a = _t(v)
        if a.is_complex():
            return (torch.round(a.real).to(torch.int32),
                    torch.round(a.imag).to(torch.int32))
        if a.is_floating_point() or a.dtype == torch.bool:
            raise _rt_err(loc, "cannot mix fixed-point complex16 with a "
                               "float array; quantize it explicitly (the "
                               "policy keeps everything in the integer "
                               "domain)")
        return a.to(torch.int32), torch.zeros(a.shape, dtype=torch.int32,
                                               device=a.device)
    a = np.asarray(v)
    if np.dtype(a.dtype).kind == "c":
        return (np.round(np.real(a)).astype(np.int32),
                np.round(np.imag(a)).astype(np.int32))
    if not np.issubdtype(np.dtype(a.dtype), np.integer):
        raise _rt_err(loc, "cannot mix fixed-point complex16 with a "
                           "float array; quantize it explicitly (the "
                           "policy keeps everything in the integer "
                           "domain)")
    return a.astype(np.int32), np.zeros(a.shape, np.int32)


def _fx_binop(op: str, a: Any, b: Any, loc):
    """Fixed-point complex16 operator semantics (C shorts model:
    components are int32 mid-expression, wrap to int16 at
    assignment/cast). Returns NotImplemented for ops whose elementwise
    fallthrough is already correct (shifts, real-scalar / and %)."""
    if op in ("==", "!="):
        ar, ai = _fx_split(a, loc)
        br, bi = _fx_split(b, loc)
        eq = _binop("&&", _binop("==", ar, br, loc),
                    _binop("==", ai, bi, loc), loc)
        return eq if op == "==" else _lnot(eq)
    if op == "*":
        ar, ai = _fx_split(a, loc)
        br, bi = _fx_split(b, loc)
        return _stack_last(_binop("-", _binop("*", ar, br, loc),
                                  _binop("*", ai, bi, loc), loc),
                           _binop("+", _binop("*", ar, bi, loc),
                                  _binop("*", ai, br, loc), loc))
    if op in ("+", "-"):
        if fx_is_pair(a) and fx_is_pair(b):
            return NotImplemented          # elementwise is exact
        ar, ai = _fx_split(a, loc)
        br, bi = _fx_split(b, loc)
        return _stack_last(_binop(op, ar, br, loc), _binop(op, ai, bi, loc))
    if op in ("/", "%") and fx_is_pair(a) and fx_is_pair(b):
        raise _rt_err(loc, f"fixed-point complex16 has no {op!r} "
                           f"between complex values; scale by real "
                           f"scalars or use the Q15 ext helpers")
    return NotImplemented      # shifts / real-divisor ops: elementwise


def _lnot(v):
    if is_static(v):
        return not v
    return np.logical_not(v) if _np_ok(v) else torch.logical_not(_t(v))


def _stack_last(re, im):
    """Stack two components on a new last axis (the fx pair layout)."""
    if _np_ok(re, im):
        return np.stack([np.asarray(re), np.asarray(im)], axis=-1)
    return torch.stack(_ts([re, im]), dim=-1)


def _t_operands(a, b):
    """Both operands of a torch binop: arrays as tensors on one device,
    C integer promotion of the narrow ints, then a Python scalar as a
    0-d tensor of the dtype jnp's weak typing gives it."""
    dev = _dev(a, b)
    ta = None if is_static(a) else _t(a, dev)
    tb = None if is_static(b) else _t(b, dev)
    if ta is not None and ta.dtype in _NARROW:
        ta = ta.to(torch.int32)
    if tb is not None and tb.dtype in _NARROW:
        tb = tb.to(torch.int32)
    if ta is None:
        ta = _t(a, dev, _py_dtype(a, tb.dtype))
    if tb is None:
        tb = _t(b, dev, _py_dtype(b, ta.dtype))
    return ta, tb


def _binop(op: str, a: Any, b: Any, loc, fxp: bool = False) -> Any:
    if fxp and (fx_is_pair(a) or fx_is_pair(b)):
        r = _fx_binop(op, a, b, loc)
        if r is not NotImplemented:
            return r
    both_static = is_static(a) and is_static(b)
    if op in ("&&", "||"):
        if both_static:
            return (bool(a) and bool(b)) if op == "&&" \
                else (bool(a) or bool(b))
        if _np_ok(a, b):
            return (np.logical_and if op == "&&" else np.logical_or)(a, b)
        dev = _dev(a, b)
        ta, tb = _t(a, dev), _t(b, dev)
        return (torch.logical_and if op == "&&" else torch.logical_or)(
            ta, tb)
    if both_static:
        try:
            if op == "/":
                if isinstance(a, int) and isinstance(b, int):
                    return _trunc_div(a, b)     # C int division
                return a / b
            if op == "%":
                if isinstance(a, int) and isinstance(b, int):
                    return a - _trunc_div(a, b) * b   # C remainder
                return math.fmod(a, b)
            return {
                "+": lambda: a + b, "-": lambda: a - b,
                "*": lambda: a * b, "**": lambda: a ** b,
                "<<": lambda: a << b, ">>": lambda: a >> b,
                "<": lambda: a < b, "<=": lambda: a <= b,
                ">": lambda: a > b, ">=": lambda: a >= b,
                "==": lambda: a == b, "!=": lambda: a != b,
                "&": lambda: a & b, "|": lambda: a | b,
                "^": lambda: a ^ b,
            }[op]()
        except TypeError:
            pass  # e.g. complex << int — fall through for the error below
    if _np_ok(a, b):
        # concrete numpy fast path — same semantics as the torch branch
        an, bn = np.asarray(a), np.asarray(b)
        if op in _ARITH_PROMOTE:
            an, bn = _promote_narrow_np(an), _promote_narrow_np(bn)
        fn = _NP_OPS.get(op)
        if fn is not None:
            return fn(an, bn)
        if op == "/":
            if (np.issubdtype(an.dtype, np.integer)
                    and np.issubdtype(bn.dtype, np.integer)):
                # C-style truncating int division (lax.div semantics),
                # exact for all of int64 — no float round-trip
                q = np.floor_divide(an, bn)
                rem = an - q * bn
                return q + ((rem != 0) & ((an < 0) != (bn < 0)))
            return np.divide(an, bn)
        if op == "%":
            if (np.issubdtype(an.dtype, np.integer)
                    and np.issubdtype(bn.dtype, np.integer)):
                q = np.floor_divide(an, bn)
                rem = an - q * bn
                # C remainder: sign of the dividend
                return rem - bn * ((rem != 0) & ((an < 0) != (bn < 0)))
            return np.fmod(an, bn)
        if op in ("&", "|", "^"):
            if an.dtype == np.bool_ and bn.dtype == np.bool_:
                return _NP_BOOL_OPS[op](an, bn)
            return _NP_BIT_OPS[op](an, bn)
        raise _rt_err(loc, f"unknown operator {op!r}")
    # the device path (C integer promotion as _promote_narrow_np)
    aj, bj = _t_operands(a, b)
    fn = _T_OPS.get(op)
    if fn is not None:
        return fn(aj, bj)
    if op == "/":
        if _t_int(aj) and _t_int(bj):
            # C-style truncating int division (lax.div semantics)
            return torch.div(aj, bj, rounding_mode="trunc")
        return torch.div(aj, bj)
    if op == "%":
        return torch.fmod(aj, bj)       # C remainder (lax.rem)
    if op in ("&", "|", "^"):
        if aj.dtype == torch.bool and bj.dtype == torch.bool:
            return _T_BOOL_OPS[op](aj, bj)
        return _T_BIT_OPS[op](aj, bj)
    raise _rt_err(loc, f"unknown operator {op!r}")


def _t_int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)


_T_OPS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "**": torch.pow,
    "<<": torch.bitwise_left_shift, ">>": torch.bitwise_right_shift,
    "<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
    "==": torch.eq, "!=": torch.ne,
}
_T_BOOL_OPS = {"&": torch.logical_and, "|": torch.logical_or,
               "^": torch.logical_xor}
_T_BIT_OPS = {"&": torch.bitwise_and, "|": torch.bitwise_or,
              "^": torch.bitwise_xor}


# --------------------------------------------------------------------------
# Expression evaluation
# --------------------------------------------------------------------------

_BASE_TYPE_NAMES = frozenset(
    ("bit", "bool", "int", "int8", "int16", "int32", "int64", "double",
     "complex", "complex16", "complex32"))


def _fx_ty_hint(e: A.Expr, scope: Scope):
    """Does `e`'s DECLARED type say complex16 (True), say something
    non-complex (False), or say nothing (None)? Used so the fx pair
    heuristic never hijacks arithmetic on variables the program
    declared as plain int arrays."""
    if isinstance(e, A.EBin):
        ha = _fx_ty_hint(e.a, scope)
        hb = _fx_ty_hint(e.b, scope)
        if ha is True or hb is True:
            return True
        if ha is False and hb is False:
            return False
        return None
    if isinstance(e, A.ECall) and e.name in _BASE_TYPE_NAMES:
        return e.name == "complex16"
    ty = None
    if isinstance(e, A.EVar):
        c = scope.find(e.name)
        ty = c.ty if c is not None else None
    elif isinstance(e, (A.EIdx, A.ESlice)) and isinstance(e.arr, A.EVar):
        c = scope.find(e.arr.name)
        if c is not None and isinstance(c.ty, A.TArr):
            ty = c.ty.elem
    if isinstance(ty, A.TArr):
        ty = ty.elem
    if isinstance(ty, A.TBase):
        return ty.name == "complex16"
    return None


def eval_expr(e: A.Expr, scope: Scope, ctx: Ctx) -> Any:
    if isinstance(e, A.EInt):
        return e.val
    if isinstance(e, A.EFloat):
        return e.val
    if isinstance(e, A.EBit):
        return e.val
    if isinstance(e, A.EBool):
        return e.val
    if isinstance(e, A.EString):
        return e.val
    if isinstance(e, A.EVar):
        return scope.lookup(e.name, e.loc)
    if isinstance(e, A.EUn):
        v = eval_expr(e.e, scope, ctx)
        if not is_static(v) and not _np_ok(v):
            v = _t(v)
            if e.op == "-":
                return torch.neg(v)
            if e.op == "~":
                return torch.bitwise_not(v)
            if e.op == "!":
                return torch.logical_not(v)
        if e.op == "-":
            return -v if is_static(v) else np.negative(v)
        if e.op == "~":
            return ~v if is_static(v) else np.bitwise_not(v)
        if e.op == "!":
            return (not v) if is_static(v) else np.logical_not(v)
        raise _rt_err(e.loc, f"unknown unary {e.op!r}")
    if isinstance(e, A.EBin):
        fxp = ctx.fxp_complex16
        if fxp:
            memo = ctx.fx_hints.get(id(e))
            if memo is None or memo[0] is not e:
                memo = (e, _fx_ty_hint(e, scope))
                ctx.fx_hints[id(e)] = memo
            if memo[1] is False:
                fxp = False   # declared non-complex: stay elementwise
        return _binop(e.op, eval_expr(e.a, scope, ctx),
                      eval_expr(e.b, scope, ctx), e.loc, fxp=fxp)
    if isinstance(e, A.ECond):
        c = eval_expr(e.c, scope, ctx)
        if is_static(c):
            return eval_expr(e.a if c else e.b, scope, ctx)
        a = eval_expr(e.a, scope, ctx)
        b = eval_expr(e.b, scope, ctx)
        if _np_ok(c, a, b):
            return np.where(c, a, b)
        return _where(c, a, b)
    if isinstance(e, A.ECall):
        return _eval_call(e, scope, ctx)
    if isinstance(e, A.EIdx):
        arr = eval_expr(e.arr, scope, ctx)
        i = eval_expr(e.i, scope, ctx)
        if isinstance(arr, dict):
            raise _rt_err(e.loc, "cannot index a struct")
        if is_static(i):
            _check_index(int(i), arr, e.loc)
            return arr[int(i)]
        if _np_ok(arr, i):
            ia = np.asarray(i)
            if ia.ndim == 0:
                # concrete scalar index: enforce C bounds discipline (no
                # Python negative wraparound) on the numpy fast path too
                _check_index(int(ia), arr, e.loc)
                return np.asarray(arr)[int(ia)]
            return np.asarray(arr)[ia]
        return _gather(arr, i)
    if isinstance(e, A.ESlice):
        arr = eval_expr(e.arr, scope, ctx)
        arr = np.asarray(arr) if _np_ok(arr) else _t(arr)
        i = eval_expr(e.i, scope, ctx)
        try:
            n = ctx.static_eval(e.n, scope)
        except NotStatic:
            raise _rt_err(e.n.loc, "slice length must be compile-time "
                                   "static (x[i, n] with static n)")
        if is_static(i):
            i = int(i)
            if i < 0 or i + n > arr.shape[0]:
                raise _rt_err(e.loc, f"slice [{i}, {n}] out of bounds for "
                                     f"array of length {arr.shape[0]}")
            return arr[i:i + int(n)]
        if isinstance(arr, np.ndarray) and _np_ok(i):
            ii = int(i)
            if ii < 0 or ii + n > arr.shape[0]:
                raise _rt_err(e.loc, f"slice [{ii}, {n}] out of bounds "
                                     f"for array of length {arr.shape[0]}")
            return arr[ii:ii + int(n)]
        return _dyn_slice(arr, i, int(n))
    if isinstance(e, A.EField):
        v = eval_expr(e.e, scope, ctx)
        if ctx.fxp_complex16 and e.f in ("re", "im") and fx_is_pair(v):
            return v[..., 0] if e.f == "re" else v[..., 1]
        if isinstance(v, dict):
            if e.f not in v:
                raise _rt_err(e.loc, f"struct {v.get('__struct__')} has "
                                     f"no field {e.f!r}")
            return v[e.f]
        if e.f == "re":
            return v.real if is_static(v) or _np_ok(v) else _real(_t(v))
        if e.f == "im":
            return v.imag if is_static(v) or _np_ok(v) else _imag(_t(v))
        raise _rt_err(e.loc, f"no field {e.f!r} on a non-struct value")
    if isinstance(e, A.EArrLit):
        vals = [eval_expr(x, scope, ctx) for x in e.elems]
        if all(is_static(v) for v in vals):
            return np.array(vals)
        if _np_ok(*vals):
            return np.stack([np.asarray(v) for v in vals])
        return torch.stack(_ts(vals))
    if isinstance(e, A.EStructLit):
        sd = ctx.structs.get(e.name)
        if sd is None:
            raise _rt_err(e.loc, f"unknown struct {e.name!r}")
        v = {fn: eval_expr(fe, scope, ctx) for fn, fe in e.fields}
        return cast_value(A.TStruct(e.name), v, ctx.structs,
                          lambda x: ctx.static_eval(x, scope),
                          fxp=ctx.fxp_complex16)
    raise _rt_err(getattr(e, "loc", (0, 0)),
                  f"unknown expression node {type(e).__name__}")


def _ty_is_cplx(ty) -> Optional[str]:
    t = ty.elem if isinstance(ty, A.TArr) else ty
    if isinstance(t, A.TBase) and t.name in _CPLX:
        return t.name
    return None


def _fx_ext_arg(v: Any, ty) -> Any:
    """Pair -> complex64 at a complex-typed ext boundary (fxp policy:
    f32 is retained only inside explicitly complex-typed ext bricks
    such as v_fft)."""
    if _ty_is_cplx(ty) and fx_is_pair(v):
        if _np_ok(v):
            a = np.asarray(v, np.float32)
            return (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)
        a = _t(v).to(torch.float32)
        return torch.complex(a[..., 0], a[..., 1])
    return v


def _fx_ext_ret(v: Any, ty) -> Any:
    """complex16-typed ext results requantize back to pairs; wider
    complex return types stay in the f32 domain."""
    if _ty_is_cplx(ty) == "complex16" and not fx_is_pair(v):
        return _fx_cast(v)
    return v


def _eval_call(e: A.ECall, scope: Scope, ctx: Ctx) -> Any:
    args = [eval_expr(a, scope, ctx) for a in e.args]
    name = e.name
    # casts / complex constructors
    if name in _BASE_TYPE_NAMES:
        if name in _CPLX and len(args) == 2:
            re, im = args
            if ctx.fxp_complex16 and name == "complex16":
                return fx_pair(re, im)
            if is_static(re) and is_static(im):
                return complex(re, im)
            if _np_ok(re, im):
                return (np.asarray(re, np.float32)
                        + 1j * np.asarray(im, np.float32)).astype(
                            np.complex64)
            dev = _dev(re, im)
            tr = _cast_t(_t(re, dev), torch.float32)
            ti = _cast_t(_t(im, dev), torch.float32)
            tr, ti = torch.broadcast_tensors(tr, ti)
            return torch.complex(tr, ti)
        if len(args) != 1:
            raise _rt_err(e.loc, f"cast {name} takes one argument")
        return cast_value(A.TBase(name), args[0], ctx.structs,
                          lambda x: ctx.static_eval(x, scope),
                          fxp=ctx.fxp_complex16)
    # user expression functions
    fd = ctx.funs.get(name)
    if fd is not None:
        if ctx.autolut and not _np_ok(*args) \
                and len(args) == len(fd.decl.params):
            # call with device args: LUT-able pure funs become
            # one table gather (lutinfer, the LUTAnalysis role); arity
            # mismatches fall through to call_fun's clear error rather
            # than zip-truncating into a wrong table index
            from ziria_tpu_torch.frontend import lutinfer
            spec = lutinfer.spec_for_fun(name, fd, ctx)
            if spec is not None \
                    and lutinfer.args_match_spec(spec, args):
                table = ctx.lut_tables.get(name)
                if table is None:
                    try:
                        table = lutinfer.build_fun_table(spec, fd, ctx)
                    except (lutinfer.TableTooLarge, ZiriaRuntimeError):
                        # output too big for the cap, or a body the
                        # domain sweep cannot evaluate — permanently
                        # fall back to the direct call
                        ctx.lut_specs[name] = None
                        spec = None
                    else:
                        ctx.lut_tables[name] = table
                if spec is not None:
                    return lutinfer.gather(
                        table, lutinfer.encode_args(spec, args))
        return call_fun(fd, args, ctx, e.loc)
    # ext / builtin functions
    fn = ctx.exts.get(name)
    if fn is not None:
        sig = ctx.ext_sigs.get(name) if ctx.fxp_complex16 else None
        if sig is not None:
            args = [_fx_ext_arg(v, p.ty)
                    for v, p in zip(args, sig.params)]
            return _fx_ext_ret(fn(*args), sig.ret_ty)
        return fn(*args)
    # print family
    if name in ("print", "println", "error"):
        msg = "".join(_fmt_value(a) for a in args)
        if name == "error":
            raise ZiriaRuntimeError(f"error: {msg}")
        ctx.on_print(msg + ("\n" if name == "println" else ""))
        return None
    raise _rt_err(e.loc, f"unknown function {name!r}")


def _check_index(i: int, arr: Any, loc) -> None:
    """C-like bounds discipline: no Python negative wraparound."""
    n = np.shape(arr)[0] if np.shape(arr) else None
    if n is None:
        raise _rt_err(loc, "cannot index a scalar")
    if i < 0 or i >= n:
        raise _rt_err(loc, f"index {i} out of bounds for array of "
                           f"length {n}")


def _fmt_value(v: Any) -> str:
    if hasattr(v, "dtype") and tuple(getattr(v, "shape", (1,))) == ():
        try:
            v = v.item()
        except Exception:
            pass
    return str(v)


def call_fun(fd: FunDef, args: List[Any], ctx: Ctx, loc=(0, 0)) -> Any:
    d = fd.decl
    if len(args) != len(d.params):
        raise _rt_err(loc, f"{d.name}: expected {len(d.params)} args, "
                           f"got {len(args)}")
    s = fd.closure.child()
    for p, v in zip(d.params, args):
        ty = p.ty
        # length-polymorphic array params adopt the argument's length
        if ty is not None:
            v = cast_value(ty, v, ctx.structs,
                           lambda x: ctx.static_eval(x, fd.closure),
                           fxp=ctx.fxp_complex16)
        s.declare(p.name, v, ty, mutable=False)
    r = exec_stmts(d.body, s, ctx)
    v = r[1] if r is not None else None
    if d.ret_ty is not None and v is not None:
        v = cast_value(d.ret_ty, v, ctx.structs,
                       lambda x: ctx.static_eval(x, fd.closure),
                       fxp=ctx.fxp_complex16)
    return v


# --------------------------------------------------------------------------
# Statement execution
# --------------------------------------------------------------------------


def exec_stmts(stmts, scope: Scope, ctx: Ctx) -> Optional[Tuple[str, Any]]:
    """Run statements; returns ('ret', v) if a `return` fired, else None."""
    for st in stmts:
        r = exec_stmt(st, scope, ctx)
        if r is not None:
            return r
    return None


def exec_stmt(st: A.Stmt, scope: Scope, ctx: Ctx) -> Optional[Tuple[str, Any]]:
    if isinstance(st, A.SVar):
        se = lambda x: ctx.static_eval(x, scope)   # noqa: E731
        if st.init is not None:
            v = cast_value(st.ty, eval_expr(st.init, scope, ctx),
                           ctx.structs, se, fxp=ctx.fxp_complex16)
        else:
            v = zero_value(st.ty, ctx.structs, se,
                           fxp=ctx.fxp_complex16)
        scope.declare(st.name, v, st.ty, mutable=True)
        return None
    if isinstance(st, A.SLet):
        v = eval_expr(st.e, scope, ctx)
        if st.ty is not None:
            v = cast_value(st.ty, v, ctx.structs,
                           lambda x: ctx.static_eval(x, scope),
                           fxp=ctx.fxp_complex16)
        scope.declare(st.name, v, st.ty, mutable=False)
        return None
    if isinstance(st, A.SAssign):
        v = eval_expr(st.e, scope, ctx)
        _assign_lval(st.lval, v, scope, ctx)
        return None
    if isinstance(st, A.SIf):
        c = eval_expr(st.c, scope, ctx)
        if is_static(c):
            return exec_stmts(st.then if c else st.els, scope.child(), ctx)
        if np.ndim(c) >= 1 or (_MODE["kind"] == "vmap" and _is_batched(c)):
            # lane-vector condition (vectorized loop mode) OR a scalar
            # that differs per firing under vmap (the reference's
            # traced condition): where-merge / per-lane select
            return _staged_if(c, st, scope, ctx)
        return exec_stmts(st.then if _sync_bool(c, st.loc) else st.els,
                          scope.child(), ctx)      # concrete (np or sync)
    if isinstance(st, A.SFor):
        try:
            start = ctx.static_eval(st.start, scope)
            count = ctx.static_eval(st.count, scope)
        except NotStatic:
            if _tracing() and not _has_return(st.body):
                # a trip count that differs per firing under vmap (the
                # reference's traced bound, which lax.fori_loop takes):
                # no eager loop can run it
                s_v = eval_expr(st.start, scope, ctx)
                c_v = eval_expr(st.count, scope, ctx)
                if _size(s_v) == 1 and _size(c_v) == 1:
                    raise DeviceControlError(
                        f"{st.loc[0]}:{st.loc[1]}: for-loop bounds differ "
                        f"per firing (under vmap)")
            raise _rt_err(st.loc, "for-loop bounds must be compile-time "
                                  "static (use while for dynamic trip "
                                  "counts)")
        if int(count) >= FORI_MIN_COUNT and _tracing() \
                and not _has_return(st.body) \
                and _reads_traced(st.body, scope):
            # large loop over device data inside a device block: the
            # lane-vector and GF(2) rewrites get their chance (the
            # reference stages it as ONE lax.fori_loop); loops over
            # host values keep the interpreter's loop
            return _staged_for(int(start), int(count), st, scope, ctx)
        counted = _MODE["kind"] is not None
        for i in range(int(start), int(start) + int(count)):
            if counted:
                COUNTS["device_loop_iters"] += 1
            s = scope.child()
            s.declare(st.var, i, None, mutable=False)
            r = exec_stmts(st.body, s, ctx)
            if r is not None:
                return r
        return None
    if isinstance(st, A.SWhile):
        while True:
            c = eval_expr(st.c, scope, ctx)
            if _size(c) != 1:
                # a non-scalar condition is a bug in the program, not a
                # device-loop situation — diagnose it as such
                raise _rt_err(st.loc,
                              f"while condition must be a scalar "
                              f"boolean, got shape {np.shape(c)}")
            if _is_traced(c):
                # device condition (possibly only from this iteration
                # on): the rest of the loop runs as a device loop
                return _staged_while(st, scope, ctx)
            if not _sync_bool(c, st.loc):
                return None
            r = exec_stmts(st.body, scope.child(), ctx)
            if r is not None:
                return r
    if isinstance(st, A.SReturn):
        return ("ret", eval_expr(st.e, scope, ctx))
    if isinstance(st, A.SExpr):
        eval_expr(st.e, scope, ctx)
        return None
    raise _rt_err(st.loc, f"unknown statement {type(st).__name__}")


# statement for-loops at or above this trip count, reading device data
# inside a device block, take the device-loop path (_staged_for: lane
# vector, GF(2), else a counted plain loop); below it they run as the
# interpreter's loop, as the reference unrolls them
FORI_MIN_COUNT = 24


def _tracing() -> bool:
    """True inside a device block (the reference: under a jax trace)."""
    return _MODE["kind"] is not None


def _expr_reads(e: Optional[A.Expr], acc: set) -> None:
    for x in A.iter_exprs(e):
        if isinstance(x, A.EVar):
            acc.add(x.name)


def _stmt_reads(stmts, acc: set) -> None:
    for x in A.iter_stmt_exprs(stmts):
        if isinstance(x, A.EVar):
            acc.add(x.name)


def _reads_traced(stmts, scope: Scope) -> bool:
    """Does this body read any name currently bound to a device value?
    (Over-approximates: locally-declared names are included but resolve
    to outer cells or nothing — both harmless.)"""
    names: set = set()
    _stmt_reads(stmts, names)
    for name in names:
        c = scope.find(name)
        if c is not None and _is_traced(c.value):
            return True
    return False


def _has_return(stmts) -> bool:
    return any(isinstance(st, A.SReturn) for st in A.iter_stmts(stmts))


def _stmt_writes(stmts, acc: set) -> None:
    """Names assigned (lval roots) or var-declared in this body —
    the set a device block writes back. Over-approximates with
    body-local declarations; those resolve to shadowing outer cells or
    nothing, both harmless."""
    for st in A.iter_stmts(stmts):
        if isinstance(st, (A.SVar, A.SLet)):
            acc.add(st.name)
        elif isinstance(st, A.SAssign):
            e = st.lval
            while isinstance(e, (A.EIdx, A.ESlice, A.EField)):
                e = e.e if isinstance(e, A.EField) else e.arr
            if isinstance(e, A.EVar):
                acc.add(e.name)


# elementwise-safe calls a vectorized loop body may contain: base-type
# casts/constructors plus the elementwise ext math bricks. Anything
# else (user funs, v_* vector bricks, effects) bails to the next
# device-loop path.
_VECTOR_SAFE_CALLS = _BASE_TYPE_NAMES | frozenset(
    ("sin", "cos", "tan", "atan", "atan2", "sqrt", "exp", "log",
     "abs", "conj", "floor", "ceil", "round", "sign"))


class _VectorBail(Exception):
    """Body not vectorizable (analysis or runtime shape failure)."""


# the errors an analysis gap of a lane-vector or GF(2) pass surfaces as
# (a lane vector where a scalar was expected, an index or dtype the
# analysis did not foresee); the pass then restores its cells and the
# next device-loop path runs. Anything else, a device fault above all
# (torch.cuda.OutOfMemoryError and CUDA errors are RuntimeErrors),
# propagates.
ANALYSIS_GAPS = (TypeError, IndexError, ValueError)


def _affine_in(e: A.Expr, var: str):
    """`e` as a*var + b with STATIC int a != 0 and b free of `var`.
    Returns (a, b_ast_or_int) or None. b is returned as an AST (or 0)
    to be evaluated loop-invariantly by the caller."""
    if isinstance(e, A.EVar) and e.name == var:
        return 1, 0
    if isinstance(e, A.EBin):
        if e.op == "+":
            la, ra = _affine_in(e.a, var), _affine_in(e.b, var)
            if la is not None and ra is None \
                    and var not in _free_names(e.b):
                return la[0], _add_ast(la[1], e.b)
            if ra is not None and la is None \
                    and var not in _free_names(e.a):
                return ra[0], _add_ast(ra[1], e.a)
        elif e.op == "-":
            la = _affine_in(e.a, var)
            if la is not None and var not in _free_names(e.b):
                return la[0], _sub_ast(la[1], e.b)
        elif e.op == "*":
            if isinstance(e.a, A.EInt) and isinstance(e.b, A.EVar) \
                    and e.b.name == var and e.a.val != 0:
                return int(e.a.val), 0
            if isinstance(e.b, A.EInt) and isinstance(e.a, A.EVar) \
                    and e.a.name == var and e.b.val != 0:
                return int(e.b.val), 0
    return None


def _free_names(e: Optional[A.Expr]) -> set:
    out: set = set()
    _expr_reads(e, out)
    return out


def _add_ast(b, e):
    if isinstance(b, int) and b == 0:
        return e
    ba = A.EInt(val=b) if isinstance(b, int) else b
    return A.EBin(op="+", a=ba, b=e)


def _sub_ast(b, e):
    ba = A.EInt(val=b) if isinstance(b, int) else b
    return A.EBin(op="-", a=ba, b=e)


def _vector_plan(st: A.SFor, scope: Scope, ctx: Ctx):
    """Analyze a statement for-loop body for lane-vector execution.

    Eligible bodies contain only: local SCALAR declarations, pure
    elementwise expressions (whitelisted calls), writes to body-local
    scalars, additive updates to outer scalars, and element writes to
    outer arrays whose indices are affine in the loop var with static
    stride — same-array sites (after collapsing structurally-equal
    index expressions, e.g. the two arms of an if writing the same
    element) sharing one stride with pairwise distinct static offsets
    mod stride (so scatter lanes never collide and site order is
    immaterial across lanes). A nested loop is allowed only outside an
    if, with bounds free of the loop var and the body's locals, and a
    body that writes only scalar locals (its own or this body's); it
    runs as a plain loop over lane vectors. No other nested loops, no
    local arrays (their per-iteration privacy has no lane
    representation), no returns.

    Outer-scalar updates classify two ways:

    - **affine induction** (`v := v +/- c`, ONE unconditional site, c
      loop-invariant): per-lane entry values are a closed form (ints)
      or a sequential-rounding scan (floats) — the r3 machinery.
    - **general int induction** (any number of sites, conditional
      and/or var-dependent steps — the depuncture `src := src + 1`
      under `keep == 1`, the parity `par := par + sbits[t]`): per-lane
      contributions are DISCOVERED by a first vector pass over the
      body with the scalar pinned to its entry value broadcast (lane i
      then holds v0 + own-contributions); an exclusive cumsum turns
      the contributions into exact per-lane entry values for the real
      pass (VERDICT r3 next #4). Ints only — lane-summation order
      never changes an int result, while float cumsum rounds
      differently than the sequential loop. Pass-1 masks must be
      discovery-stable: no if condition and no induction step may
      (transitively through locals or written arrays) read a general
      induction var.

    Written arrays may be read (read-modify-write) when every read
    index is affine with the same stride and each (read, write) offset
    pair is either structurally identical (a lane reads only what IT
    wrote — program order within the lane is preserved by vector
    execution) or provably non-colliding ((br-bw) % stride != 0).

    Returns {"inductions": {name: (sign, step_ast)}, "gen": {names}}
    or None.
    """
    var = st.var
    decl_names: set = set()     # every name declared ANYWHERE in body
    scalar_sites: dict = {}     # name -> [(sign, step_ast, in_if)]
    arr_sites: dict = {}        # name -> [(a, b_static_or_None, idx_ast)]
    arr_reads: dict = {}        # name -> [(a, b_static_or_None, idx_ast)]
    bare_reads: set = set()     # names read other than via affine EIdx
    deps: dict = {}             # written name -> names its values read
    cond_names: set = set()     # names dynamic if-conditions read
    body_writes: set = set()    # every name the body may assign
    _stmt_writes(st.body, body_writes)

    def expr_ok(e) -> bool:
        for x in A.iter_exprs(e):
            if isinstance(x, A.ECall):
                if x.name not in _VECTOR_SAFE_CALLS:
                    return False
            elif isinstance(x, A.ESlice):
                # slice reads with var-dependent starts have no single
                # gather form; allow only var-free slices
                if var in _free_names(x.i):
                    return False
        return True

    def note_reads(e):
        # array read sites: affine gathers are provable against write
        # sites; anything else marks the array as opaquely read
        base_ids: set = set()
        for x in A.iter_exprs(e):
            if isinstance(x, A.EIdx) and isinstance(x.arr, A.EVar):
                base_ids.add(id(x.arr))
                aff = _affine_in(x.i, var)
                if aff is None:
                    bare_reads.add(x.arr.name)
                else:
                    a, b = aff
                    bs = b if isinstance(b, int) else (
                        int(b.val) if isinstance(b, A.EInt) else None)
                    arr_reads.setdefault(x.arr.name, []).append(
                        (a, bs, x.i))
            elif isinstance(x, A.ESlice) and isinstance(x.arr, A.EVar):
                base_ids.add(id(x.arr))
                bare_reads.add(x.arr.name)
            elif isinstance(x, A.EVar) and id(x) not in base_ids:
                bare_reads.add(x.name)

    def inner_ok(s: A.SFor, lc: set) -> bool:
        # a nested loop whose iterations only write this body's own
        # scalar locals (a correlation's inner sum): it runs as a plain
        # loop over lane vectors, each lane adding in the loop's order,
        # so every lane's value is the sequential loop's bit for bit.
        # Its bounds must be the same on every lane
        if var in _free_names(s.start) | _free_names(s.count) \
                or (_free_names(s.start) | _free_names(s.count)) & lc:
            return False
        try:
            ctx.static_eval(s.start, scope)
            ctx.static_eval(s.count, scope)
        except NotStatic:
            return False
        inner = {s.var}
        decl_names.add(s.var)
        for t in s.body:
            if isinstance(t, (A.SVar, A.SLet)):
                if isinstance(t.ty, A.TArr) or t.name in (var, s.var):
                    return False
                e = t.init if isinstance(t, A.SVar) else t.e
                if e is not None:
                    if not expr_ok(e):
                        return False
                    note_reads(e)
                inner.add(t.name)
                decl_names.add(t.name)
            elif isinstance(t, A.SAssign) and isinstance(t.lval, A.EVar) \
                    and (t.lval.name in lc or t.lval.name in inner):
                if not expr_ok(t.e):
                    return False
                note_reads(t.e)
                deps.setdefault(t.lval.name, set()).update(
                    _free_names(t.e))
            else:
                return False
        return True

    def walk(stmts, in_if: bool, outer_locals: set) -> bool:
        # lexically-scoped local tracking: a declaration is visible
        # from its statement onward WITHIN this block (and nested
        # arms), and dies with the block — an arm-local must not make
        # a later outer-scalar write look local (code review r3)
        lc = set(outer_locals)
        for s in stmts:
            if isinstance(s, A.SFor) and not in_if and NESTED_LANE_PASS:
                if not inner_ok(s, lc):
                    return False
                continue
            if isinstance(s, (A.SWhile, A.SFor, A.SReturn)):
                return False
            if isinstance(s, (A.SVar, A.SLet)):
                if s.name == var:
                    return False
                if isinstance(s.ty, A.TArr):
                    return False   # local array: no lane privacy
                init = s.init if isinstance(s, A.SVar) else s.e
                if init is not None and not expr_ok(init):
                    return False
                if init is not None:
                    note_reads(init)
                    deps.setdefault(s.name, set()).update(
                        _free_names(init))
                lc.add(s.name)
                decl_names.add(s.name)
            elif isinstance(s, A.SIf):
                # statically-decided branches (rate-dispatch literals):
                # analyze only the live arm, mirroring exec_stmt's
                # fold — dead arms would otherwise poison the plan
                # (e.g. mixed demap strides across nbpsc arms). Only
                # safe when no body-local shadows a condition name
                # (execution resolves the LOCAL, the fold saw the
                # outer) AND nothing the body writes feeds the
                # condition — a concrete pre-loop value of a variable
                # the loop updates would freeze a branch the analysis
                # then never checks while execution still runs it
                fn = _free_names(s.c)
                if not (fn & lc) and var not in fn \
                        and not (fn & body_writes):
                    try:
                        cv = ctx.static_eval(s.c, scope)
                    except Exception:
                        cv = None
                    if cv is not None and is_static(cv):
                        if not walk(s.then if cv else s.els, in_if, lc):
                            return False
                        continue
                if not expr_ok(s.c):
                    return False
                note_reads(s.c)
                cond_names.update(fn)
                if not walk(s.then, True, lc) \
                        or not walk(s.els, True, lc):
                    return False
            elif isinstance(s, A.SAssign):
                if not expr_ok(s.e):
                    return False
                note_reads(s.e)
                lv = s.lval
                if isinstance(lv, A.EVar):
                    if lv.name in lc:
                        deps.setdefault(lv.name, set()).update(
                            _free_names(s.e))
                        continue
                    cell = scope.find(lv.name)
                    if cell is None or not cell.mutable:
                        return False
                    # outer scalar: additive update sites only
                    # (v := v +/- e or v := e + v, v not in e);
                    # classification into affine vs general induction
                    # happens after the walk
                    e = s.e
                    site = None
                    if isinstance(e, A.EBin) and e.op in "+-":
                        if isinstance(e.a, A.EVar) \
                                and e.a.name == lv.name \
                                and lv.name not in _free_names(e.b) \
                                and expr_ok(e.b):
                            site = (1 if e.op == "+" else -1, e.b)
                        elif e.op == "+" and isinstance(e.b, A.EVar) \
                                and e.b.name == lv.name \
                                and lv.name not in _free_names(e.a) \
                                and expr_ok(e.a):
                            site = (1, e.a)
                    if site is None:
                        return False
                    deps.setdefault(lv.name, set()).update(
                        _free_names(site[1]))
                    scalar_sites.setdefault(lv.name, []).append(
                        (site[0], site[1], in_if))
                elif isinstance(lv, A.EIdx) \
                        and isinstance(lv.arr, A.EVar):
                    name = lv.arr.name
                    if name in lc:
                        return False   # local arrays already rejected
                    cell = scope.find(name)
                    if cell is None or not cell.mutable:
                        return False
                    if not expr_ok(lv.i):
                        return False
                    aff = _affine_in(lv.i, var)
                    if aff is None:
                        return False
                    a, b = aff
                    note_reads(lv.i)
                    deps.setdefault(name, set()).update(
                        _free_names(s.e) | _free_names(lv.i))
                    b_static = b if isinstance(b, int) else (
                        int(b.val) if isinstance(b, A.EInt) else None)
                    arr_sites.setdefault(name, []).append(
                        (a, b_static, lv.i))
                else:
                    return False
            elif isinstance(s, A.SExpr):
                return False       # call for effect: not vectorizable
            else:
                return False
        return True

    if not walk(st.body, False, set()):
        return None

    # ---- written arrays: collapse structurally-equal index sites
    # (if-arm pairs), then prove scatter lanes never collide, and
    # check every read of a written array against the RMW rules.
    # EVERY site index offset must be loop-invariant (free of names
    # the body writes or declares): a per-lane-varying offset breaks
    # the injectivity the whole collision argument rests on (code
    # review r4: `a[k - s] := a[k - s] + x` with s an induction had
    # every lane resolving to one element)
    loop_varying = set(scalar_sites) | set(arr_sites) | decl_names
    for name, sites in arr_sites.items():
        uniq: list = []
        for site in sites:
            if not any(site[2] == u[2] for u in uniq):
                uniq.append(site)
        arr_sites[name] = uniq
        for _a, _b, idx in uniq:
            if _free_names(idx) & loop_varying:
                return None
        if len(uniq) > 1:
            a0 = uniq[0][0]
            if any(a != a0 or b is None for a, b, _i in uniq):
                return None
            offs = [b % abs(a0) for _a, b, _i in uniq]
            if len(set(offs)) != len(offs):
                return None
        if name in bare_reads:
            return None
        for ra, rb, ri in arr_reads.get(name, ()):
            if _free_names(ri) & loop_varying:
                return None
            for wa, wb, wi in uniq:
                if ri == wi:
                    continue      # lane reads only what IT writes
                if ra != wa or rb is None or wb is None \
                        or (rb - wb) % abs(wa) == 0:
                    return None   # possible cross-lane collision

    # ---- outer-scalar classification: affine fast path (closed
    # form / float scan) vs general int induction (two-pass cumsum)
    inductions: dict = {}
    gen: set = set()
    written = set(arr_sites) | set(scalar_sites)
    for name, sites in scalar_sites.items():
        if len(sites) == 1 and not sites[0][2] \
                and not (_free_names(sites[0][1])
                         & ({var} | written | decl_names)):
            inductions[name] = (sites[0][0], sites[0][1])
        else:
            gen.add(name)

    if gen:
        # ints only: lane-order summation is exact for ints; float
        # cumsum rounds differently than the sequential loop
        for name in gen:
            v0 = scope.find(name).value
            dt = getattr(v0, "dtype", None)
            if dt is not None:
                if np.ndim(v0) != 0 \
                        or not np.issubdtype(dt, np.integer):
                    return None
            elif isinstance(v0, bool) or not isinstance(
                    v0, (int, np.integer)):
                return None
        # discovery stability: pass 1 runs with general vars pinned to
        # broadcast entry values, so nothing that decides which sites
        # fire (if conditions) or what they add (steps) may read a
        # general var — directly or through locals/arrays it flowed
        # into
        tainted = set(gen)
        changed = True
        while changed:
            changed = False
            for nm, srcs in deps.items():
                if nm not in tainted and srcs & tainted:
                    tainted.add(nm)
                    changed = True
        if cond_names & tainted:
            return None
        for name, sites in scalar_sites.items():
            for _sgn, step, _inif in sites:
                if _free_names(step) & tainted:
                    return None
    return {"inductions": inductions, "gen": gen}


def _lane_pass(stmts, scope: Scope, ctx: Ctx):
    """Run a loop body once over lane vectors (marking the pass so a
    loop nested in it runs plainly)."""
    _MODE["lanes"] += 1
    try:
        return exec_stmts(stmts, scope, ctx)
    finally:
        _MODE["lanes"] -= 1


def _vectorized_for(start: int, count: int, st: A.SFor, scope: Scope,
                    ctx: Ctx) -> bool:
    """Execute an eligible statement loop as ONE lane-vector pass:
    the loop variable becomes arange(n), scalar locals become lane
    vectors, data-dependent ifs become per-lane selects (the value-
    select machinery), and outer-array element writes become single
    scatters — the reference vectorizer's widening, applied to
    statement loops (SURVEY.md §2.1 Vectorize), which also removes
    the per-iteration launches of a plain device loop. Returns True
    when it ran; False leaves all state untouched (caller falls back to
    the next device-loop path)."""
    plan = _vector_plan(st, scope, ctx)
    if plan is None:
        return False
    dev = _dev()
    n = int(count)
    if n <= 0:
        return False

    # rollback snapshot: every mutable cell value currently visible
    snap = [(c, c.value) for _n, c in scope.mutable_cells_named()]

    def lane_scope(gen_entries):
        """Child scope with the loop var as arange, affine-induction
        shadows at their per-lane entry values, and general-induction
        shadows at `gen_entries[name]`. Returns (scope, finals)."""
        vs = scope.child()
        i_vec = torch.arange(start, start + n, dtype=torch.int32,
                             device=dev)
        vs.declare(st.var, i_vec, None, mutable=False)
        finals: dict = {}
        for name, (sgn, step_ast) in plan["inductions"].items():
            v0 = scope.lookup(name, st.loc)
            c = eval_expr(step_ast, scope, ctx)     # loop-invariant
            if np.ndim(c) != 0 or np.ndim(v0) != 0:
                raise _VectorBail("non-scalar induction")
            stepv = c if sgn > 0 else _neg(c)
            if _is_int_val(v0) and _is_int_val(stepv):
                # exact closed form
                starts = _binop("+", v0, _binop(
                    "*", torch.arange(n, dtype=torch.int32, device=dev),
                    stepv, st.loc), st.loc)
                finals[name] = _binop("+", v0, _binop("*", n, stepv,
                                                      st.loc), st.loc)
            else:
                # float induction: reproduce SEQUENTIAL accumulation
                # bit-for-bit (closed form rounds differently)
                starts, finals[name] = _seq_accumulate(v0, stepv, n, dev)
            # shadow cell: body updates hit the lane vector, the final
            # scalar goes to the outer cell afterwards
            vs.declare(name, starts, None, mutable=True)
        for name, entry in gen_entries.items():
            vs.declare(name, entry, None, mutable=True)
        return vs, finals

    try:
        gen = plan["gen"]
        gen_entries: dict = {}
        if gen:
            # PASS 1 (discovery): every general induction var pinned to
            # its entry value broadcast over lanes — after the pass,
            # lane i holds v0 + (its own iteration's contributions);
            # all other cell mutations are discarded. The plan's taint
            # check guarantees the contributions themselves don't
            # depend on the pinned (wrong-prefix) values.
            v0s, pins = {}, {}
            for name in gen:
                v0 = scope.lookup(name, st.loc)
                if np.ndim(v0) != 0:
                    raise _VectorBail("non-scalar induction")
                v0s[name] = v0
                t0 = _t(v0, dev)
                pins[name] = torch.zeros((n,), dtype=t0.dtype,
                                         device=dev) + t0
            vs1, _f = lane_scope(pins)
            r = _lane_pass(st.body, vs1, ctx)
            if r is not None:
                raise _VectorBail("return inside vector loop")
            for name in gen:
                t = _t(vs1.lookup(name), dev)
                if tuple(t.shape) != (n,):
                    raise _VectorBail("induction lost lane shape")
                t0 = _t(v0s[name], dev)
                t = t - t0
                # exact per-lane entry: v0 + sum of lower lanes' totals
                gen_entries[name] = (t0 + torch.cumsum(t, 0).to(t.dtype)
                                     - t)
            for c, v in snap:          # discard pass-1 side effects
                c.value = v

        vs, finals = lane_scope(gen_entries)
        r = _lane_pass(st.body, vs, ctx)
        if r is not None:                 # pragma: no cover - walked
            raise _VectorBail("return inside vector loop")
        for name, fin in finals.items():
            scope.assign(name, fin, ctx, st.loc)
        for name in gen:
            # last lane's exit value = v0 + all contributions
            scope.assign(name, _t(vs.lookup(name), dev)[-1],
                         ctx, st.loc)
        return True
    except (_VectorBail, ZiriaRuntimeError) + ANALYSIS_GAPS:
        # an analysis gap restores every cell and falls back to the
        # next device-loop path, which re-raises genuine program errors
        # with diagnostics; a device fault propagates
        for c, v in snap:
            c.value = v
        return False


def _neg(v):
    if isinstance(v, torch.Tensor):
        return torch.neg(v)
    return -v if is_static(v) else np.negative(v)


def _is_int_val(v) -> bool:
    if isinstance(v, torch.Tensor):
        return _t_int(v)
    if is_static(v):
        return isinstance(v, int) and not isinstance(v, bool)
    return np.issubdtype(np.asarray(v).dtype, np.integer)


def _seq_accumulate(v0, step, n: int, dev):
    """(per-lane entry values, exit value) of `v := v + step` run n
    times, rounding as the sequential loop does (the reference's
    lax.scan). On the host when both values are host values: float32
    numpy adds round as the card's do, one copy instead of n launches."""
    if _np_ok(v0, step):
        dt = np_dtype(_common_dtype([v0, step]))
        a, c = np.asarray(v0).astype(dt), np.asarray(step).astype(dt)
        out = np.empty((n,), dt)
        for k in range(n):
            out[k] = a
            a = a + c
        return _t(out, dev), a
    a, c = _ts([v0, step], dev)
    outs = []
    for _k in range(n):
        outs.append(a)
        a = a + c
    return torch.stack(outs), a


def _staged_for(start, count, st: A.SFor, scope: Scope,
                ctx: Ctx, try_gf2: bool = True):
    """The device-loop path of one statement for-loop (the reference
    stages it as `lax.fori_loop`). In the reference's order: the
    lane-vector lowering, then GF(2) compression, then a plain Python
    loop over device tensors with the loop variable a Python int --
    the interpreter's semantics, one launch per op per iteration,
    counted in COUNTS["device_loop_iters"]. `start`/`count` are ints
    (a bound that differs per firing under vmap raised before)."""
    # try the lane-vector lowering first: eligible bodies (affine
    # scatters, per-lane selects, induction closed forms) run as ONE
    # vector pass instead of `count` iterations
    # (a loop nested in a lane-vector pass holds per-lane scalars that
    # neither rewrite models: it runs as the plain loop below)
    lanes = _MODE["lanes"] > 0
    if not lanes and isinstance(start, int) and isinstance(count, int) \
            and _vectorized_for(start, count, st, scope, ctx):
        return None

    # then GF(2) affine-recurrence compression (frontend/gf2.py): LFSR
    # family loops (scramble/descramble/CRC) collapse to K-iteration
    # bit-matrix blocks; `try_gf2=False` marks its own remainder-tail
    # re-entry
    if try_gf2 and not lanes:
        from .gf2 import gf2_for
        if gf2_for(start, count, st, scope, ctx):
            return None

    start, count = int(start), int(count)
    for i in range(start, start + count):
        COUNTS["device_loop_iters"] += 1
        s = scope.child()
        s.declare(st.var, i, None, mutable=False)
        r = exec_stmts(st.body, s, ctx)
        if r is not None:          # unreachable: _has_return pre-check
            raise _rt_err(st.loc, "return inside a device for-loop")
    return None


def _staged_while(st: A.SWhile, scope: Scope, ctx: Ctx):
    """Dynamic-condition `while` inside a device block (the reference
    stages it as `lax.while_loop`): a plain loop whose condition syncs
    once an iteration (counted); under vmap a condition that differs
    per firing raises DeviceControlError."""
    while True:
        c = eval_expr(st.c, scope, ctx)
        if _size(c) != 1:
            raise _rt_err(st.loc,
                          f"while condition must be a scalar boolean, "
                          f"got shape {tuple(np.shape(c))}")
        if not _sync_bool(c, st.loc):
            return None
        COUNTS["device_loop_iters"] += 1
        r = exec_stmts(st.body, scope.child(), ctx)
        if r is not None:
            return r


def _value_select_plans(st: A.SIf, scope: Scope, size_floor: int = 4096):
    """Big-buffer writes mergeable at VALUE level instead of buffer
    level. The default staged-if merge selects whole cell values; for
    `if c then { dep[i] := e1 } else { dep[i] := e2 }` over a 131072-
    element frame buffer that is a full-buffer select per execution —
    inside a staged loop, gigabytes of memory traffic (measured: it WAS
    the wifi receiver's entire per-symbol cost). When every write to a
    big cell is a single top-level element assignment through the SAME
    index expression (and the cell is otherwise untouched by the arms),
    the merge can instead select the scalar and store once.

    Returns [(name, lval_ast)] of rewritable cells.
    """
    def elem_writes(arm):
        out: Dict[str, List[A.SAssign]] = {}
        for s in arm:
            if isinstance(s, A.SAssign) and isinstance(s.lval, A.EIdx) \
                    and isinstance(s.lval.arr, A.EVar):
                out.setdefault(s.lval.arr.name, []).append(s)
        return out

    then_w, else_w = elem_writes(st.then), elem_writes(st.els)
    plans = []
    for name in sorted(set(then_w) | set(else_w)):
        cell = scope.find(name)
        if cell is None or not cell.mutable:
            continue
        try:
            if _size(cell.value) <= size_floor:
                continue
        except Exception:       # pragma: no cover - exotic cell values
            continue
        wt = then_w.get(name, [])
        we = else_w.get(name, [])
        if len(wt) > 1 or len(we) > 1:
            continue
        lvs = [s.lval for s in wt + we]
        if len(lvs) == 2 and lvs[0] != lvs[1]:
            continue            # different indices: keep buffer merge
        site_stmts = set(map(id, wt + we))
        # the cell must appear NOWHERE else in the arms: not read (its
        # pre-branch slot value stands in for the untaken write), not
        # written from nested control flow
        ok = True
        for arm in (st.then, st.els):
            for s in arm:
                if id(s) in site_stmts:
                    reads: set = set()
                    _expr_reads(s.e, reads)
                    _expr_reads(s.lval.i, reads)
                    if name in reads:
                        ok = False
                else:
                    names: set = set()
                    _stmt_reads((s,), names)
                    _stmt_writes((s,), names)
                    if name in names:
                        ok = False
        if not ok:
            continue
        # deferring the store needs the index unchanged by the arms
        idx_reads: set = set()
        _expr_reads(lvs[0].i, idx_reads)
        arm_writes: set = set()
        _stmt_writes(st.then, arm_writes)
        _stmt_writes(st.els, arm_writes)
        if idx_reads & arm_writes:
            continue
        plans.append((name, lvs[0]))
    return plans


def _staged_if(cond, st: A.SIf, scope: Scope, ctx: Ctx):
    """Dynamic-condition `if`: run both arms on the live scope, snapshot
    mutable cells around each, and merge assigned cells with
    torch.where — imperative control flow as select ops. Big-buffer
    single-site writes are first rewritten to scalar value-selects
    (`_value_select_plans`) so the merge never copies frame buffers."""

    # lane-vector condition (vectorized statement loop): EVERY array
    # element write must go through the value-select rewrite — the
    # whole-cell where-merge cannot express a per-lane scatter. An
    # uncoverable write then fails the merge's shape check, which the
    # vectorizer catches to fall back to the next device-loop path.
    vec_mode = getattr(cond, "ndim", 0) and np.ndim(cond) >= 1
    plans = _value_select_plans(st, scope,
                                size_floor=0 if vec_mode else 4096)
    if plans:
        import dataclasses
        tmps = {}
        for k, (name, lval) in enumerate(plans):
            t = f"__selv{k}_{name}"
            tmps[name] = t
            scope.declare(t, eval_expr(lval, scope, ctx), None,
                          mutable=True)

        def rw(stmts):
            out = []
            for s in stmts:
                if isinstance(s, A.SAssign) and isinstance(s.lval, A.EIdx) \
                        and isinstance(s.lval.arr, A.EVar) \
                        and s.lval.arr.name in tmps:
                    out.append(dataclasses.replace(
                        s, lval=A.EVar(name=tmps[s.lval.arr.name])))
                else:
                    out.append(s)
            return tuple(out)

        def writes_in(arm, name):
            return any(isinstance(s, A.SAssign) and isinstance(s.lval, A.EIdx)
                       and isinstance(s.lval.arr, A.EVar)
                       and s.lval.arr.name == name for s in arm)

        st2 = dataclasses.replace(st, then=rw(st.then), els=rw(st.els))
        _staged_if(cond, st2, scope, ctx)
        for name, lval in plans:
            # lanes whose arm does not write the element write nothing
            # (the reference writes their old value back): a masked
            # lane's index may be out of range and wrap onto a live
            # lane's element, and the order of colliding scatter writes
            # is undefined on the card
            mask = None
            if vec_mode:
                wt, we = writes_in(st.then, name), writes_in(st.els, name)
                if wt and not we:
                    mask = cond
                elif we and not wt:
                    mask = _lnot(cond)
            _assign_lval(lval, scope.lookup(tmps[name]), scope, ctx,
                         mask=mask)
            del scope.cells[tmps[name]]
        return None
    cells = scope.mutable_cells()
    before = [c.value for c in cells]

    r1 = exec_stmts(st.then, scope.child(), ctx)
    after_then = [c.value for c in cells]
    for c, v in zip(cells, before):
        c.value = v
    r2 = exec_stmts(st.els, scope.child(), ctx)
    after_else = [c.value for c in cells]

    if r1 is not None or r2 is not None:
        raise _rt_err(st.loc, "return inside a data-dependent if is not "
                              "supported under staging")
    def merge(t, f):
        # struct cells merge field-wise (field assignment is
        # copy-on-write, so whole-dict replacement is the normal case
        # even for `p.a := x`)
        if isinstance(t, dict) or isinstance(f, dict):
            if not (isinstance(t, dict) and isinstance(f, dict)
                    and set(t) == set(f)
                    and t.get("__struct__") == f.get("__struct__")):
                raise _rt_err(
                    st.loc, "data-dependent if assigns a struct in one "
                            "arm but not the other (or structs of "
                            "different types); both arms must leave the "
                            "variable with the same struct type")
            return {k: (t[k] if k == "__struct__" else merge(t[k], f[k]))
                    for k in t}
        dev = _dev(cond, t, f)
        ta, fa = _ts([t, f], dev)
        if ta.shape != fa.shape and np.ndim(cond) == 0:
            raise _rt_err(
                st.loc, f"data-dependent if assigns incompatible shapes "
                        f"{tuple(ta.shape)} vs {tuple(fa.shape)} to the "
                        f"same variable; under staging both arms must "
                        f"produce the same shape (the merge is a where "
                        f"select)")
        c = _t(cond, dev).to(torch.bool)
        if c.ndim:
            # vectorized-loop mode (lane-vector condition): values may
            # carry trailing dims (fxp pairs) or still be pre-vector
            # scalars from an untaken path — right-expand the cond to
            # the wider side and let broadcasting unify; a genuine
            # incompatibility raises and the vectorizer falls back
            nd = max(ta.ndim, fa.ndim)
            if nd > c.ndim:
                c = c.reshape(tuple(c.shape) + (1,) * (nd - c.ndim))
        return torch.where(c, ta, fa)

    for c, b, t, f in zip(cells, before, after_then, after_else):
        if t is b and f is b:
            continue
        c.value = merge(t, f)
    return None


# an index no array reaches: a masked-off lane's write drops
_DROP_INDEX = 1 << 30


def _assign_lval(lval: A.Expr, v: Any, scope: Scope, ctx: Ctx,
                 mask: Any = None) -> None:
    """Assign `v` to `lval`. `mask` (a lane vector, element writes
    only) drops the write of every lane where it is false."""
    if isinstance(lval, A.EVar):
        scope.assign(lval.name, v, ctx, lval.loc)
        return
    if isinstance(lval, A.EIdx):
        old = eval_expr(lval.arr, scope, ctx)
        i = eval_expr(lval.i, scope, ctx)
        if mask is not None:
            if _np_ok(old, i, v, mask):
                m = np.asarray(mask, bool)
                new = np.array(old)
                ia = np.broadcast_to(np.asarray(i), m.shape)[m]
                new[ia] = np.broadcast_to(np.asarray(v), m.shape)[m] \
                    .astype(new.dtype, copy=False)
            else:
                dev = _dev(old, i, v, mask)
                it = _t(i, dev).to(torch.int64)
                it = torch.where(_t(mask, dev).to(torch.bool), it,
                                 torch.full_like(it, _DROP_INDEX))
                new = _scatter(old, it, v)
            _assign_lval(lval.arr, new, scope, ctx)
            return
        if is_static(i):
            _check_index(int(i), old, lval.loc)
        elif _np_ok(i) and np.ndim(i) == 0:
            _check_index(int(np.asarray(i)), old, lval.loc)
        if _np_ok(old, i, v):
            # concrete path: copy-on-write keeps the functional
            # semantics (arrays are values) at numpy speed
            new = np.array(old)
            if np.ndim(i) > 0:       # lane-vector scatter
                new[np.asarray(i)] = np.asarray(v).astype(
                    new.dtype, copy=False)
            else:
                new[int(i)] = np.asarray(v).astype(new.dtype,
                                                   copy=False)
        elif is_static(i) or (_np_ok(i) and np.ndim(i) == 0):
            # a host index into a device array: one static update
            new = _update_at(old, int(i), v)
        else:
            new = _scatter(old, i, v)
        _assign_lval(lval.arr, new, scope, ctx)
        return
    if isinstance(lval, A.ESlice):
        old = eval_expr(lval.arr, scope, ctx)
        i = eval_expr(lval.i, scope, ctx)
        try:
            n = ctx.static_eval(lval.n, scope)
        except NotStatic:
            raise _rt_err(lval.loc, "slice length must be static")
        if _np_ok(old, i, v):
            new = np.array(old)
            vv = np.asarray(v).astype(new.dtype, copy=False)
            new[int(i):int(i) + int(n)] = vv
            _assign_lval(lval.arr, new, scope, ctx)
            return
        old = _t(old, _dev(old, i, v))
        vv = _t(v, old.device)
        if vv.is_complex() and not old.is_complex():
            vv = vv.real
        vv = torch.broadcast_to(vv.to(old.dtype),
                                (int(n),) + tuple(old.shape[1:]))
        if is_static(i):
            i = int(i)
            new = torch.cat([old[:i], vv, old[i + int(n):]])
        else:
            new = _dyn_update_slice(old, vv, i)
        _assign_lval(lval.arr, new, scope, ctx)
        return
    if isinstance(lval, A.EField):
        old = eval_expr(lval.e, scope, ctx)
        if not isinstance(old, dict):
            raise _rt_err(lval.loc, "field assignment on a non-struct")
        new = dict(old)
        new[lval.f] = v
        _assign_lval(lval.e, new, scope, ctx)
        return
    raise _rt_err(getattr(lval, "loc", (0, 0)),
                  f"invalid assignment target {type(lval).__name__}")
