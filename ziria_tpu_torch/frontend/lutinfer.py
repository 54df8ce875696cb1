"""LUT-ability *inference* for pure surface functions (LUTAnalysis role;
counterpart of ziria_tpu/frontend/lutinfer.py).

The reference's AutoLUT is two-phase (SURVEY.md §2.1): `LUTAnalysis.hs`
decides which pure expression functions have small enough input
bit-width to tabulate, and `AutoLUT.hs`/`CgLUT.hs` synthesize the
tables. Round 1 implemented only the synthesis half, keyed off
*declared* domains (`in_domain`, or scalar `bit`/`int8` surface types).
This module is the analysis half, TPU-first:

- **Bit-width analysis** over declared surface types: every parameter
  must have a finite bit-width (`bit`/`bool` = 1, `int8` = 8,
  `int16` = 16, `arr[N] bit` = N, `arr[N] int8` = 8N) and the widths
  must sum to at most ``MAX_LUT_BITS`` (64Ki entries — the same
  practical cap the reference's LUT sizes respect).
- **Purity analysis** over the function body: only local state may be
  mutated; free variables must resolve to *immutable* bindings in the
  definition scope (global ``let`` constants get baked into the
  table); calls may reach base-type casts, other pure user functions
  (no recursion), and registered ``ext`` functions — the externals
  registry is a closed pure-math library (frontend/externals.py,
  ops/ext_math.py) — but never ``print``/``error``.
- **Table synthesis** evaluates the function over its entire packed
  input domain in ONE `torch.func.vmap` of the evaluator, and call
  sites become a single gather `table[pack(args)]` that vectorizes
  across the planner's batch axis.

Two consumers:

- the elaborator's `map f` path attaches a :class:`MapLut` to the IR
  node when `f` is inferred LUT-able, generalizing `Map.in_domain`
  (which remains the scalar-index fast path) to packed multi-bit
  items such as `arr[8] bit`; `core/autolut.py` performs the rewrite
  (CLI ``--autolut``).
- the staged evaluator's expression-call path (`eval._eval_call`)
  rewrites calls with traced arguments into table gathers when the
  program is compiled with ``autolut=True`` (CLI ``--autolut``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ziria_tpu_torch.core.autolut import MAX_TABLE_ITEMS
from ziria_tpu_torch.frontend import ast as A

# synthesis caps: domains above 2^16 would build multi-MB tables and
# lose to direct evaluation; per-entry output size is further capped
# by MAX_TABLE_ITEMS at build time
MAX_LUT_BITS = 16


class TableTooLarge(ValueError):
    """Raised by build_fun_table when domain x output size exceeds the
    table cap; expression-call sites fall back to the direct call."""


@dataclass(frozen=True)
class ArgSpec:
    """One parameter's packed-bits layout inside the LUT index."""

    name: str
    kind: str        # bit | bool | int8 | int16 | arr_bit | arr_int8
    bits: int        # total bits this argument contributes
    n: int = 0       # array length (arr_* kinds)


@dataclass(frozen=True)
class LutSpec:
    fun: str
    args: Tuple[ArgSpec, ...]

    @property
    def total_bits(self) -> int:
        return sum(a.bits for a in self.args)

    @property
    def domain(self) -> int:
        return 1 << self.total_bits


# ------------------------------------------------------------------ widths


def _arg_spec(name: str, ty: Optional[A.Ty],
              static_eval: Callable) -> Optional[ArgSpec]:
    if isinstance(ty, A.TBase):
        if ty.name in ("bit", "bool"):
            return ArgSpec(name, ty.name, 1)
        if ty.name == "int8":
            return ArgSpec(name, "int8", 8)
        if ty.name == "int16":
            return ArgSpec(name, "int16", 16)
        return None
    if isinstance(ty, A.TArr) and isinstance(ty.elem, A.TBase):
        if ty.n is None:
            return None                      # length-polymorphic
        try:
            n = int(static_eval(ty.n))
        except Exception:
            return None
        if n <= 0:
            return None
        if ty.elem.name in ("bit", "bool"):
            return ArgSpec(name, "arr_bit", n, n)
        if ty.elem.name == "int8":
            return ArgSpec(name, "arr_int8", 8 * n, n)
    return None


# ------------------------------------------------------------------ purity


def _lval_root(e: A.Expr) -> Optional[str]:
    while isinstance(e, (A.EIdx, A.ESlice, A.EField)):
        e = e.e if isinstance(e, A.EField) else e.arr
    return e.name if isinstance(e, A.EVar) else None


def _pure_expr(e: Optional[A.Expr], locals_: Set[str], fd, ctx,
               seen: Set[str]) -> bool:
    if e is None:
        return True
    if isinstance(e, A.EVar):
        if e.name in locals_:
            return True
        cell = fd.closure.find(e.name)
        # immutable closure bindings (global `let` constants) are baked
        # into the table; anything mutable would make the table stale
        return cell is not None and not cell.mutable
    if isinstance(e, A.ECall):
        from ziria_tpu_torch.frontend.eval import _BASE_TYPE_NAMES
        if not all(_pure_expr(a, locals_, fd, ctx, seen) for a in e.args):
            return False
        if e.name in _BASE_TYPE_NAMES:
            return True
        if e.name in ("print", "println", "error"):
            return False
        sub = ctx.funs.get(e.name)
        if sub is not None:
            return _pure_fun_body(e.name, sub, ctx, seen)
        # registered externals: a closed pure-DSP-math registry
        return e.name in ctx.exts
    # all other node kinds are pure iff their children are
    # (A.child_exprs raises on unknown nodes — fail closed)
    return all(_pure_expr(k, locals_, fd, ctx, seen)
               for k in A.child_exprs(e))


def _pure_stmts(stmts, locals_: Set[str], fd, ctx, seen: Set[str]) -> bool:
    for st in stmts:
        if isinstance(st, (A.SVar, A.SLet)):
            init = st.init if isinstance(st, A.SVar) else st.e
            if not _pure_expr(init, locals_, fd, ctx, seen):
                return False
            locals_.add(st.name)
        elif isinstance(st, A.SAssign):
            root = _lval_root(st.lval)
            if root is None or root not in locals_:
                return False                 # writes must stay local
            if not _pure_expr(st.lval, locals_, fd, ctx, seen):
                return False
            if not _pure_expr(st.e, locals_, fd, ctx, seen):
                return False
        elif isinstance(st, A.SIf):
            if not _pure_expr(st.c, locals_, fd, ctx, seen):
                return False
            if not _pure_stmts(st.then, set(locals_), fd, ctx, seen):
                return False
            if not _pure_stmts(st.els, set(locals_), fd, ctx, seen):
                return False
        elif isinstance(st, A.SFor):
            if not _pure_expr(st.start, locals_, fd, ctx, seen):
                return False
            if not _pure_expr(st.count, locals_, fd, ctx, seen):
                return False
            if not _pure_stmts(st.body, set(locals_) | {st.var},
                               fd, ctx, seen):
                return False
        elif isinstance(st, A.SWhile):
            if not _pure_expr(st.c, locals_, fd, ctx, seen):
                return False
            if not _pure_stmts(st.body, set(locals_), fd, ctx, seen):
                return False
        elif isinstance(st, A.SReturn):
            if not _pure_expr(st.e, locals_, fd, ctx, seen):
                return False
        elif isinstance(st, A.SExpr):
            if not _pure_expr(st.e, locals_, fd, ctx, seen):
                return False
        else:
            return False
    return True


def _pure_fun_body(name: str, fd, ctx, seen: Set[str]) -> bool:
    if name in seen:
        return False                         # (mutual) recursion
    seen = seen | {name}
    locals_ = {p.name for p in fd.decl.params}
    return _pure_stmts(fd.decl.body, locals_, fd, ctx, seen)


# ------------------------------------------------------------------ analysis


def spec_for_fun(name: str, fd, ctx) -> Optional[LutSpec]:
    """LUT-ability verdict for one user function: packed-input spec if
    every parameter is small and the body is pure, else None. Memoized
    per Ctx (declarations are immutable once elaborated)."""
    memo: Dict[str, Optional[LutSpec]] = ctx.lut_specs
    if name in memo:
        return memo[name]
    spec: Optional[LutSpec] = None
    d = fd.decl
    if d.params:
        def se(e, _fd=fd, _ctx=ctx):
            return _ctx.static_eval(e, _fd.closure)
        args = [_arg_spec(p.name, p.ty, se) for p in d.params]
        if all(a is not None for a in args) \
                and sum(a.bits for a in args) <= MAX_LUT_BITS \
                and _pure_fun_body(name, fd, ctx, set()):
            spec = LutSpec(name, tuple(args))
    memo[name] = spec
    return spec


# ---------------------------------------------------------------- pack/unpack


def args_match_spec(spec: LutSpec, args: List[Any]) -> bool:
    """Shapes must agree with the spec before packing: a mismatched
    array length would silently broadcast into a garbage index, where
    the direct call raises a clear length error — so mismatches fall
    back to the direct path."""
    if len(args) != len(spec.args):
        return False
    for a, v in zip(spec.args, args):
        if a.kind in ("bit", "bool", "int8", "int16"):
            if np.ndim(v) != 0:
                return False
        else:
            shp = np.shape(v)
            if len(shp) != 1 or shp[0] != a.n:
                return False
    return True


def encode_args(spec: LutSpec, args: List[Any]) -> Any:
    """Pack runtime argument values into the LUT index (works on device
    and batched tensors; first arg occupies the high bits)."""
    from ziria_tpu_torch.frontend.eval import _dev, _t

    dev = _dev(*args)
    idx = None
    for a, v in zip(spec.args, args):
        x = _t(v, dev)
        if a.kind == "bool":
            # nonzero-is-True, matching cast_value's bool semantics
            enc = (x != 0).to(torch.int32)
        else:
            x = x.to(torch.int32)
            if a.kind == "bit":
                enc = x & 1
            elif a.kind == "int8":
                enc = x & 0xFF
            elif a.kind == "int16":
                enc = x & 0xFFFF
            elif a.kind == "arr_bit":
                enc = torch.sum((x & 1) << torch.arange(
                    a.n, dtype=torch.int32, device=dev), -1)
            else:                                # arr_int8
                enc = torch.sum((x & 0xFF) << (8 * torch.arange(
                    a.n, dtype=torch.int32, device=dev)), -1)
        idx = enc if idx is None else (idx << a.bits) | enc
    return idx.to(torch.int32)


def decode_index(spec: LutSpec, idx: Any) -> List[Any]:
    """Unpack a LUT index into per-parameter values (used under vmap at
    table-build time; dtypes match the runtime item conventions —
    call_fun re-casts through the declared types anyway)."""
    idx = torch.as_tensor(idx).to(torch.int32)
    dev = idx.device
    out: List[Any] = []
    for a in reversed(spec.args):
        low = idx & ((1 << a.bits) - 1)
        idx = idx >> a.bits
        if a.kind == "bit":
            out.append(low.to(torch.uint8))
        elif a.kind == "bool":
            out.append((low & 1).to(torch.bool))
        elif a.kind == "int8":
            out.append(low.to(torch.int8))
        elif a.kind == "int16":
            out.append(low.to(torch.int16))
        elif a.kind == "arr_bit":
            out.append(((low >> torch.arange(a.n, dtype=torch.int32,
                                             device=dev)) & 1)
                       .to(torch.uint8))
        else:                                # arr_int8
            out.append(((low >> (8 * torch.arange(
                a.n, dtype=torch.int32, device=dev))) & 0xFF)
                .to(torch.int8))
    out.reverse()
    return out


# ---------------------------------------------------------------- synthesis


# domains small enough to build row-by-row in the concrete evaluator
# when the staged (vmap) build hits a staging limitation — notably
# `return` inside a data-dependent if, which concrete evaluation
# handles fine (this mirrors the reference, whose LUT generation was
# compile-time evaluation and therefore immune to codegen limits)
STATIC_BUILD_MAX = 4096


def _decode_static(spec: LutSpec, idx: int) -> List[Any]:
    """Python/numpy unpack of one index for concrete row evaluation."""
    out: List[Any] = []
    for a in reversed(spec.args):
        low = idx & ((1 << a.bits) - 1)
        idx >>= a.bits
        if a.kind == "bit":
            out.append(low)
        elif a.kind == "bool":
            out.append(bool(low))
        elif a.kind == "int8":
            out.append(low - 256 if low >= 128 else low)
        elif a.kind == "int16":
            out.append(low - 65536 if low >= 32768 else low)
        elif a.kind == "arr_bit":
            out.append(np.array([(low >> i) & 1 for i in range(a.n)],
                                np.uint8))
        else:                                # arr_int8
            by = [(low >> (8 * i)) & 0xFF for i in range(a.n)]
            out.append(np.array(by, np.uint8).astype(np.int8))
    out.reverse()
    return out


def build_fun_table(spec: LutSpec, fd, ctx) -> Any:
    """Evaluate the function over its whole packed domain: one
    ``torch.func.vmap`` of the evaluator over the domain's indices, or
    — for small domains, when a row's control depends on its index —
    one concrete evaluation per row.

    Memoized on ``ctx.lut_tables`` (shared by map-position and
    expression-call sites: one build per function per program). The
    MAX_TABLE_ITEMS output cap is enforced on the first row's size
    before the whole domain is built."""
    from ziria_tpu_torch.frontend.eval import (ZiriaRuntimeError, _dev,
                                               _t, call_fun, device_mode)

    memo = ctx.lut_tables
    if spec.fun in memo:
        return memo[spec.fun]
    dev = _dev()

    def one(i):
        return call_fun(fd, decode_index(spec, i), ctx)

    def leaves(r):
        return list(r.values())[1:] if isinstance(r, dict) else [r]

    staging_err = None
    table = None
    try:
        with device_mode("block", dev):
            row = one(torch.zeros((), dtype=torch.int32, device=dev))
        row_items = sum(int(np.prod(np.shape(v))) for v in leaves(row))
        if row_items * spec.domain > MAX_TABLE_ITEMS:
            raise TableTooLarge(
                f"{spec.fun}: LUT would hold {row_items * spec.domain} "
                f"items (> {MAX_TABLE_ITEMS} cap)")
        if not isinstance(row, dict):
            with device_mode("vmap", dev):
                table = torch.func.vmap(lambda i: _t(one(i)))(
                    torch.arange(spec.domain, dtype=torch.int32,
                                 device=dev))
    except ZiriaRuntimeError as e:
        staging_err = e                      # row control differs

    if table is None:
        if staging_err is None:
            staging_err = ZiriaRuntimeError(
                f"{spec.fun}: struct-valued LUT rows")
        if spec.domain > STATIC_BUILD_MAX:
            raise staging_err
        rows = [call_fun(fd, _decode_static(spec, i), ctx)
                for i in range(spec.domain)]
        if any(isinstance(r, dict) for r in rows):
            raise staging_err
        table = _t(np.stack([np.asarray(r) for r in rows]), dev)
        # row shape was unknowable upfront on this path
        if table.numel() > MAX_TABLE_ITEMS:
            raise TableTooLarge(
                f"{spec.fun}: LUT of {table.numel()} items exceeds the "
                f"{MAX_TABLE_ITEMS}-item cap")
    memo[spec.fun] = table
    return table


def gather(table: Any, idx: Any) -> Any:
    """table[idx] across an arbitrary output (struct returns)."""
    if isinstance(table, dict):
        return {k: (v if k == "__struct__" else v[idx])
                for k, v in table.items()}
    return table[idx]


class MapLut:
    """Adapter attached to `ir.Map.lut` by the elaborator: carries the
    inferred spec plus everything `core/autolut.py` needs to rewrite the
    map into a gather without importing the frontend."""

    def __init__(self, spec: LutSpec, fd, ctx):
        self.spec = spec
        self.fd = fd
        self.ctx = ctx

    @property
    def domain(self) -> int:
        return self.spec.domain

    def build_table(self) -> Any:
        return build_fun_table(self.spec, self.fd, self.ctx)

    def encode(self, x: Any) -> Any:
        return encode_args(self.spec, [x])

    def encoder(self) -> Callable[[Any], Any]:
        """A pack closure over ONLY the spec — the rewritten map must
        not retain the FunDef/Ctx (the whole elaboration context) once
        the table is built."""
        spec = self.spec
        return lambda x: encode_args(spec, [x])

    def __repr__(self):
        return (f"MapLut({self.spec.fun}: {self.spec.total_bits} bits, "
                f"domain {self.spec.domain})")
