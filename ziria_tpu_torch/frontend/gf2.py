"""GF(2) affine loop compression ("autolin") — LFSRs without the loop
(counterpart of ziria_tpu/frontend/gf2.py).

The lane vectorizer (`eval._vectorized_for`) refuses true recurrences:
a loop whose iteration reads state the previous iteration wrote has no
per-lane form. But the recurrences that actually appear in PHY code —
scramblers, descramblers, CRC/FCS registers, PN generators — are all
*affine over GF(2)*: every carried bit of iteration p+1 is an XOR of
carried bits of iteration p, input-stream bits, and a constant. An
affine step composes: K iterations collapse into one matrix-vector
product over GF(2),

    s'   = M_K s  xor  B_K x  xor  c_K
    y[i] = O_i s  xor  P_i x  xor  q_i        (per-iteration outputs)

with every matrix computable at trace time. This pass

  1. symbolically executes ONE loop iteration over an affine-GF(2)
     bit domain (bits are XOR-sets of symbols; anything nonlinear
     bails),
  2. composes K=64 iterations into numpy bit matrices,
  3. runs the loop as a Python loop over n // K blocks of tiny mod-2
     matmuls (the reference: a `lax.fori_loop`) plus the remainder
     tail on the ordinary device-loop path — bit-exact by
     construction. CUDA has no integer matmul, so the products run on
     0/1 values in float32 (with TF32 off), exact below 2^24, as
     ops/crc.py computes the CRC.

Loop-variable comparisons (`if (p >= 16) ...`) are handled by *range
splitting*: breakpoints are discovered during symbolic execution and
the iteration domain is split until every subrange is branch-constant;
subranges that fail the analysis run through the ordinary staged path,
so engagement is never a correctness question.

Reference anchor: SURVEY.md §2.1 AutoLUT (compile-time analysis that
replaces a computation family wholesale); the reference kept LFSRs
fast by emitting them as C scalar loops — on an accelerator the
idiomatic answer is linear algebra over GF(2), not a faster scalar
loop.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import ast as A

__all__ = ["gf2_for"]

K_BLOCK = 64          # iterations folded into one block step
MAX_STATE_BITS = 512  # composition cost cap (numpy, trace-time)
MAX_UNROLL = 512      # inner static-loop unroll cap (symbolic exec)
_MAX_SPLITS = 24      # range-splitting refinement rounds


class _Bail(Exception):
    """Body is not (provably) GF(2)-affine; caller falls back."""


# --------------------------------------------------------------------------
# Symbolic values
#
# SBit  ("b", mask, c): XOR of the symbols set in `mask` plus const c.
# SVec  ("v", (SBit, ...)): a bit array.
# SInt  ("i", a, b): the integer a*p + b (a == 0 => loop-invariant).
# Concrete numpy arrays / Python scalars pass through raw.
# --------------------------------------------------------------------------


def _bit(c: int):
    return ("b", 0, int(c) & 1)


def _is_sbit(v) -> bool:
    return isinstance(v, tuple) and len(v) == 3 and v[0] == "b"


def _is_svec(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and v[0] == "v"


def _is_sint(v) -> bool:
    return isinstance(v, tuple) and len(v) == 3 and v[0] == "i"


def _xor(a, b):
    return ("b", a[1] ^ b[1], a[2] ^ b[2])


def _npdt(dt):
    """numpy dtype of a numpy or torch dtype."""
    if isinstance(dt, torch.dtype):
        from .eval import np_dtype
        return np_dtype(dt)
    return np.dtype(dt)


def _as_sbit(v):
    """Concrete 0/1 (int/np scalar) or SBit -> SBit. A non-0/1 value
    is NOT a bit — masking it mod 2 would silently change program
    results, so refuse (code review r4)."""
    if _is_sbit(v):
        return v
    if _is_sint(v):
        if v[1] != 0:
            raise _Bail("p-dependent value used as a bit")
        v = v[2]
    if isinstance(v, np.ndarray) and v.ndim == 0:
        v = v.item()
    if isinstance(v, (bool, int, np.integer)):
        if int(v) not in (0, 1):
            raise _Bail(f"non-bit value {int(v)} used as a bit")
        return _bit(int(v))
    raise _Bail(f"not a bit: {type(v).__name__}")


def _as_int(v) -> "Tuple[int, int]":
    """Value -> (a, b) meaning a*p + b with static ints."""
    if _is_sint(v):
        return v[1], v[2]
    if isinstance(v, (bool, int, np.integer)):
        return 0, int(v)
    if isinstance(v, np.ndarray) and v.ndim == 0 \
            and np.issubdtype(v.dtype, np.integer):
        return 0, int(v)
    raise _Bail("not a static/affine int")


def _const_of(v) -> int:
    a, b = _as_int(v)
    if a != 0:
        raise _Bail("p-dependent where loop-invariant int required")
    return b


# --------------------------------------------------------------------------
# One-iteration symbolic execution
# --------------------------------------------------------------------------

_CMP_OPS = frozenset(("<", "<=", ">", ">=", "==", "!="))


class _Sym:
    """Symbolically executes the loop body once at a representative
    iteration index, classifying outer names into state cells, input
    sites (p-affine stream reads, stride 1) and output sites
    (p-affine stream writes, stride 1, unconditional, never read).

    Produces the per-iteration affine map; collects the breakpoints of
    any loop-variable comparison it resolved so the planner can split
    the domain and re-run until branch decisions are range-constant.
    """

    def __init__(self, st: A.SFor, scope, ctx, p_rep: int):
        self.st = st
        self.var = st.var
        self.scope = scope
        self.ctx = ctx
        self.p_rep = p_rep
        self.breakpoints: Set[int] = set()
        self.state: Dict[str, Tuple[int, int, bool]] = {}  # name -> (base, nbits, scalar?)
        self.n_state = 0
        self.in_sites: Dict[Tuple[str, int], int] = {}     # (name, b) -> sym
        self.in_order: List[Tuple[str, int]] = []
        self.out_names: Set[str] = set()
        self.out_writes: Dict[str, Dict[int, tuple]] = {}  # name -> {b: SBit}
        self.n_ops = 0

    # -- classification ----------------------------------------------------

    def _classify(self) -> None:
        """Pre-classify written outer names: output arrays (every
        access is a p-indexed element write, zero reads) vs state
        cells (bit scalars / bit arrays of static shape)."""
        reads: Set[str] = set()
        writes: Dict[str, List[A.Expr]] = {}

        def note_expr(e):
            from .eval import _expr_reads
            _expr_reads(e, reads)

        def walk(stmts):
            for s in A.iter_stmts(stmts):
                if isinstance(s, A.SAssign):
                    lv = s.lval
                    if isinstance(lv, A.EIdx) and isinstance(lv.arr, A.EVar):
                        writes.setdefault(lv.arr.name, []).append(lv)
                        note_expr(lv.i)
                    elif isinstance(lv, A.ESlice) \
                            and isinstance(lv.arr, A.EVar):
                        writes.setdefault(lv.arr.name, []).append(lv)
                        note_expr(lv.i)
                        note_expr(lv.n)
                    elif isinstance(lv, A.EVar):
                        writes.setdefault(lv.name, []).append(lv)
                    else:
                        raise _Bail("unsupported lval")
                    note_expr(s.e)
                elif isinstance(s, (A.SVar,)):
                    if s.init is not None:
                        note_expr(s.init)
                elif isinstance(s, A.SLet):
                    note_expr(s.e)
                elif isinstance(s, A.SIf):
                    note_expr(s.c)
                elif isinstance(s, A.SFor):
                    note_expr(s.start)
                    note_expr(s.count)
                elif isinstance(s, A.SWhile):
                    raise _Bail("while in body")
                elif isinstance(s, (A.SExpr, A.SReturn)):
                    raise _Bail("effect/return in body")

        walk(self.st.body)

        locals_: Set[str] = set()
        for s in A.iter_stmts(self.st.body):
            if isinstance(s, (A.SVar, A.SLet)):
                locals_.add(s.name)

        for name, lvs in writes.items():
            if name in locals_:
                continue
            cell = self.scope.find(name)
            if cell is None or not cell.mutable:
                raise _Bail(f"write to non-mutable outer {name!r}")
            all_p_elem = all(
                isinstance(lv, A.EIdx)
                and self.var in _free(lv.i) for lv in lvs)
            v = cell.value
            dt = getattr(v, "dtype", None)
            if all_p_elem and name not in reads:
                # output stream: must be a 1-D bit array — any other
                # dtype has no GF(2) representation (code review r4:
                # an int32 output would be silently truncated mod 2)
                if np.ndim(v) != 1 or dt is None \
                        or _npdt(dt) != np.uint8:
                    raise _Bail(f"output {name!r} is not a bit array")
                self.out_names.add(name)
            else:
                nd = np.ndim(v)
                if nd == 0:
                    # scalar state must itself be a bit: uint8 cells
                    # (the runtime's `bit` representation) or a python
                    # 0/1 — an int32 counter is NOT 1-bit state
                    if dt is not None:
                        if _npdt(dt) != np.uint8:
                            raise _Bail(
                                f"state {name!r} is not a bit cell")
                    elif not (isinstance(v, (bool, int, np.integer))
                              and int(v) in (0, 1)):
                        raise _Bail(f"state {name!r} is not a bit cell")
                    nbits, scalar = 1, True
                elif nd == 1 and dt is not None \
                        and _npdt(dt) == np.uint8:
                    nbits, scalar = int(v.shape[0]), False
                else:
                    raise _Bail(f"state {name!r} is not a bit cell")
                if self.n_state + nbits > MAX_STATE_BITS:
                    raise _Bail("state too wide")
                self.state[name] = (self.n_state, nbits, scalar)
                self.n_state += nbits

    # -- expression evaluation --------------------------------------------

    def _tick(self):
        self.n_ops += 1
        if self.n_ops > 200_000:
            raise _Bail("symbolic execution too large")

    def _in_sym(self, name: str, b: int) -> tuple:
        key = (name, b)
        sym = self.in_sites.get(key)
        if sym is None:
            cell = self.scope.find(name)
            if cell is None:
                raise _Bail(f"unknown input {name!r}")
            v = cell.value
            if np.ndim(v) != 1:
                raise _Bail(f"input {name!r} is not 1-D")
            dt = getattr(v, "dtype", None)
            if dt is None or _npdt(dt) != np.uint8:
                raise _Bail(f"input {name!r} is not a bit stream")
            sym = MAX_STATE_BITS + len(self.in_order)
            self.in_sites[key] = sym
            self.in_order.append(key)
        return ("b", 1 << sym, 0)

    def sev(self, e: A.Expr, env: Dict[str, Any]):
        self._tick()
        if isinstance(e, A.EInt):
            return ("i", 0, int(e.val))
        if isinstance(e, A.EBit):
            return _bit(e.val)
        if isinstance(e, A.EBool):
            return ("i", 0, int(e.val))
        if isinstance(e, A.EFloat):
            raise _Bail("float in body")
        if isinstance(e, A.EVar):
            if e.name == self.var:
                return ("i", 1, 0)
            if e.name in env:
                return env[e.name]
            if e.name in self.out_names:
                raise _Bail(f"read of output array {e.name!r}")
            cell = self.scope.find(e.name)
            if cell is None:
                raise _Bail(f"unbound {e.name!r}")
            v = cell.value
            if isinstance(v, (bool, int, np.integer)):
                return ("i", 0, int(v))
            if isinstance(v, np.ndarray) and v.ndim == 0 \
                    and np.issubdtype(v.dtype, np.integer):
                return ("i", 0, int(v))
            if isinstance(v, np.ndarray):
                return v          # concrete constant array
            raise _Bail(f"opaque read of {e.name!r}")
        if isinstance(e, A.EIdx):
            if isinstance(e.arr, A.EVar) and e.arr.name not in env \
                    and e.arr.name != self.var:
                name = e.arr.name
                if name in self.state or name in self.out_names:
                    pass        # fall through to env/state handling
                else:
                    a, b = _as_int(self.sev(e.i, env))
                    if a == 0:
                        arr = self.sev(e.arr, env)
                        return self._index(arr, b)
                    if a != 1:
                        raise _Bail("input stride != 1")
                    return self._in_sym(name, b)
            arr = self.sev(e.arr, env)
            a, b = _as_int(self.sev(e.i, env))
            if a != 0:
                raise _Bail("p-indexed read of local/state array")
            return self._index(arr, b)
        if isinstance(e, A.ESlice):
            arr = self.sev(e.arr, env)
            i = _const_of(self.sev(e.i, env))
            n = _const_of(self.sev(e.n, env))
            if _is_svec(arr):
                if not (0 <= i and i + n <= len(arr[1])):
                    raise _Bail("slice out of range")
                return ("v", arr[1][i:i + n])
            if isinstance(arr, np.ndarray):
                return arr[i:i + n]
            raise _Bail("slice of non-array")
        if isinstance(e, A.EUn):
            v = self.sev(e.e, env)
            if e.op in ("!", "~"):
                b = _as_sbit(v)
                return ("b", b[1], b[2] ^ 1)
            if e.op == "-":
                a, c = _as_int(v)
                return ("i", -a, -c)
            raise _Bail(f"unary {e.op}")
        if isinstance(e, A.EBin):
            return self._binop(e, env)
        if isinstance(e, A.ECond):
            c = self.sev(e.c, env)
            cb = self._cond_value(c)
            if isinstance(cb, bool):
                return self.sev(e.a if cb else e.b, env)
            t = self.sev(e.a, env)
            f = self.sev(e.b, env)
            return self._merge_val(cb, t, f)
        if isinstance(e, A.ECall):
            raise _Bail(f"call {e.name!r} in body")
        raise _Bail(f"expr {type(e).__name__}")

    def _index(self, arr, i: int):
        if _is_svec(arr):
            if not (0 <= i < len(arr[1])):
                raise _Bail("index out of range")
            return arr[1][i]
        if isinstance(arr, np.ndarray):
            if not (0 <= i < arr.shape[0]):
                raise _Bail("index out of range")
            el = arr[i]
            if np.dtype(arr.dtype) == np.uint8:
                return _bit(int(el))
            if np.issubdtype(arr.dtype, np.integer):
                return ("i", 0, int(el))
            raise _Bail("non-integer constant array")
        raise _Bail("index of non-array")

    def _binop(self, e: A.EBin, env):
        op = e.op
        a = self.sev(e.a, env)
        b = self.sev(e.b, env)
        if op == "^":
            return _xor(_as_sbit(a), _as_sbit(b))
        if op in ("&", "&&", "|", "||"):
            # linear only when one side is constant
            sa, sb = _as_sbit(a), _as_sbit(b)
            for x, y in ((sa, sb), (sb, sa)):
                if x[1] == 0:
                    if op in ("&", "&&"):
                        return y if x[2] else _bit(0)
                    return _bit(1) if x[2] else y
            raise _Bail("nonlinear bit product")
        if op in _CMP_OPS:
            return self._compare(op, a, b)
        # integer arithmetic on affine forms
        (aa, ab), (ba, bb) = _as_int(a), _as_int(b)
        if op == "+":
            return ("i", aa + ba, ab + bb)
        if op == "-":
            return ("i", aa - ba, ab - bb)
        if op == "*":
            if aa == 0:
                return ("i", ab * ba, ab * bb)
            if ba == 0:
                return ("i", aa * bb, ab * bb)
            raise _Bail("quadratic in loop var")
        if aa != 0 or ba != 0:
            raise _Bail(f"op {op} on p-affine value")
        x, y = ab, bb
        if op == "/":
            if y == 0:
                raise _Bail("static division by zero")
            q = abs(x) // abs(y)
            return ("i", 0, q if (x >= 0) == (y >= 0) else -q)
        if op == "%":
            if y == 0:
                raise _Bail("static modulo by zero")
            q = abs(x) // abs(y)
            q = q if (x >= 0) == (y >= 0) else -q
            return ("i", 0, x - q * y)
        if op == "<<":
            return ("i", 0, x << y)
        if op == ">>":
            return ("i", 0, x >> y)
        if op == "**":
            return ("i", 0, x ** y)
        raise _Bail(f"op {op}")

    def _compare(self, op, a, b):
        if (_is_sbit(a) or _is_sbit(b)) and op in ("==", "!="):
            sa, sb = _as_sbit(a), _as_sbit(b)
            eq = ("b", sa[1] ^ sb[1], sa[2] ^ sb[2] ^ 1)
            return eq if op == "==" else ("b", eq[1], eq[2] ^ 1)
        (aa, ab), (ba, bb) = _as_int(a), _as_int(b)
        da, db = aa - ba, bb - ab          # compare da*p  vs  db
        if da == 0:
            v = {"<": db > 0, "<=": db >= 0, ">": db < 0,
                 ">=": db <= 0, "==": db == 0, "!=": db != 0}[op]
            return ("i", 0, int(v))
        # loop-variable comparison: record the crossing so the planner
        # splits the domain there, then resolve at the representative
        q = db // da                       # floor crossing of da*p == db
        for bp in (q, q + 1):
            self.breakpoints.add(int(bp))
        p = self.p_rep
        lhs, rhs = da * p, db
        v = {"<": lhs < rhs, "<=": lhs <= rhs, ">": lhs > rhs,
             ">=": lhs >= rhs, "==": lhs == rhs, "!=": lhs != rhs}[op]
        return ("i", 0, int(v))

    # -- statements --------------------------------------------------------

    def _cond_value(self, c):
        """Condition -> python bool (decided) or SBit (symbolic)."""
        if _is_sbit(c):
            if c[1] == 0:
                return bool(c[2])
            return c
        return bool(_const_of(c))

    def _merge_val(self, cond, t, f):
        """Per-bit select(cond, t, f); affine only when t xor f is a
        constant per bit: sel = f xor cond*(t xor f)."""
        if _is_svec(t) or _is_svec(f):
            if not (_is_svec(t) and _is_svec(f)
                    and len(t[1]) == len(f[1])):
                raise _Bail("branch shape mismatch")
            return ("v", tuple(self._merge_val(cond, x, y)
                               for x, y in zip(t[1], f[1])))
        if _is_sbit(t) or _is_sbit(f):
            tb, fb = _as_sbit(t), _as_sbit(f)
            d = _xor(tb, fb)
            if d[1] != 0:
                raise _Bail("branch difference not constant")
            return _xor(fb, cond) if d[2] else fb
        ta, fa = _as_int(t), _as_int(f)
        if ta != fa:
            raise _Bail("int differs across symbolic branches")
        return ("i",) + ta

    def _exec(self, stmts, env: Dict[str, Any]) -> None:
        for s in stmts:
            self._tick()
            if isinstance(s, (A.SVar, A.SLet)):
                if s.name in env:
                    # shadowing a tracked name: the inner-loop env
                    # copy-back could leak it — refuse conservatively
                    raise _Bail(f"shadowing declaration {s.name!r}")
                init = s.init if isinstance(s, A.SVar) else s.e
                if init is None:
                    env[s.name] = self._zero(s.ty)
                else:
                    env[s.name] = self.sev(init, env)
            elif isinstance(s, A.SAssign):
                self._assign(s, env)
            elif isinstance(s, A.SIf):
                c = self._cond_value(self.sev(s.c, env))
                if isinstance(c, bool):
                    self._exec(s.then if c else s.els, env)
                    continue
                saved_out = {k: dict(v)
                             for k, v in self.out_writes.items()}
                t_env = dict(env)
                self._exec(s.then, t_env)
                t_out = self.out_writes
                self.out_writes = saved_out
                f_env = dict(env)
                self._exec(s.els, f_env)
                f_out = self.out_writes
                # a stream write under a symbolic condition cannot be
                # merged without the old array value (never modeled)
                if t_out != f_out:
                    raise _Bail("conditional stream write")
                self.out_writes = t_out
                # merge environments per-bit: sel = f ^ cond&(t^f)
                for k in set(t_env) | set(f_env):
                    tv, fv = t_env.get(k), f_env.get(k)
                    if tv is None or fv is None:
                        env.pop(k, None)   # branch-local declaration
                        continue
                    if tv is fv:
                        env[k] = tv
                    elif isinstance(tv, np.ndarray) \
                            or isinstance(fv, np.ndarray):
                        if isinstance(tv, np.ndarray) \
                                and isinstance(fv, np.ndarray) \
                                and np.array_equal(tv, fv):
                            env[k] = tv
                        else:
                            raise _Bail("array differs across branches")
                    elif tv == fv:
                        env[k] = tv
                    else:
                        env[k] = self._merge_val(c, tv, fv)
            elif isinstance(s, A.SFor):
                st_i = _const_of(self.sev(s.start, env))
                cnt = _const_of(self.sev(s.count, env))
                if cnt < 0 or cnt > MAX_UNROLL:
                    raise _Bail("inner loop too long to unroll")
                for i in range(st_i, st_i + cnt):
                    inner = dict(env)
                    inner[s.var] = ("i", 0, i)
                    self._exec(s.body, inner)
                    for k, v in inner.items():
                        if k != s.var and k in env:
                            env[k] = v
            else:
                raise _Bail(f"stmt {type(s).__name__}")

    def _zero(self, ty):
        if isinstance(ty, A.TArr):
            try:
                n = self.ctx.static_eval(ty.n, self.scope)
            except Exception:
                raise _Bail("dynamic local array length")
            base = getattr(ty.elem, "name", None)
            if base == "bit":
                return ("v", tuple(_bit(0) for _ in range(int(n))))
            raise _Bail("non-bit local array")
        base = getattr(ty, "name", None)
        if base == "bit":
            return _bit(0)
        if base in ("int", "int8", "int16", "int32", "int64", "bool"):
            return ("i", 0, 0)
        raise _Bail(f"local of type {base}")

    def _assign(self, s: A.SAssign, env) -> None:
        lv = s.lval
        v = self.sev(s.e, env)
        if isinstance(lv, A.EVar):
            name = lv.name
            if name in env:
                cur = env[name]
                if _is_svec(cur):
                    if not _is_svec(v) or len(v[1]) != len(cur[1]):
                        raise _Bail("array assign shape mismatch")
                    env[name] = v
                elif _is_sbit(cur):
                    env[name] = _as_sbit(v)
                else:
                    env[name] = ("i",) + _as_int(v)
                return
            raise _Bail(f"assign to unclassified {name!r}")
        if isinstance(lv, A.EIdx) and isinstance(lv.arr, A.EVar):
            name = lv.arr.name
            if name in self.out_names:
                a, b = _as_int(self.sev(lv.i, env))
                if a != 1:
                    raise _Bail("output stride != 1")
                site = self.out_writes.setdefault(name, {})
                if b not in site and len(site) >= 1:
                    raise _Bail("multiple output sites per array")
                site[b] = _as_sbit(v)
                return
            if name in env:
                i = _const_of(self.sev(lv.i, env))
                cur = env[name]
                if not _is_svec(cur) or not (0 <= i < len(cur[1])):
                    raise _Bail("bad element write")
                bits = list(cur[1])
                bits[i] = _as_sbit(v)
                env[name] = ("v", tuple(bits))
                return
            raise _Bail(f"element write to unclassified {name!r}")
        if isinstance(lv, A.ESlice) and isinstance(lv.arr, A.EVar):
            name = lv.arr.name
            if name not in env:
                raise _Bail(f"slice write to unclassified {name!r}")
            i = _const_of(self.sev(lv.i, env))
            n = _const_of(self.sev(lv.n, env))
            cur = env[name]
            if not _is_svec(cur) or not (0 <= i and i + n <= len(cur[1])):
                raise _Bail("bad slice write")
            if _is_svec(v):
                src = v[1]
            elif isinstance(v, np.ndarray) and v.ndim == 1:
                src = tuple(_bit(int(x)) for x in v)
            else:
                raise _Bail("slice write of non-array")
            if len(src) != n:
                raise _Bail("slice write length mismatch")
            bits = list(cur[1])
            bits[i:i + n] = list(src)
            env[name] = ("v", tuple(bits))
            return
        raise _Bail("unsupported lval")

    # -- entry -------------------------------------------------------------

    def run(self):
        """Execute one iteration; return the per-iteration affine map
        as numpy bit matrices, or raise _Bail."""
        self._classify()
        if self.n_state == 0 and not self.out_names:
            raise _Bail("no state and no outputs")
        env: Dict[str, Any] = {}
        for name, (base, nbits, scalar) in self.state.items():
            if scalar:
                env[name] = ("b", 1 << base, 0)
            else:
                env[name] = ("v", tuple(("b", 1 << (base + k), 0)
                                        for k in range(nbits)))
        self.out_writes = {}
        self._exec(self.st.body, env)

        n_s, n_x = self.n_state, len(self.in_order)

        def decode(sb, rs, rx):
            mask, c = sb[1], sb[2]
            for k in range(n_s):
                if mask >> k & 1:
                    rs[k] ^= 1
            for j in range(n_x):
                if mask >> (MAX_STATE_BITS + j) & 1:
                    rx[j] ^= 1
            if mask >> (MAX_STATE_BITS + n_x):
                raise _Bail("internal: unknown symbol")
            return c

        M = np.zeros((n_s, n_s), dtype=np.uint8)
        B = np.zeros((n_s, n_x), dtype=np.uint8)
        c = np.zeros((n_s,), dtype=np.uint8)
        for name, (base, nbits, scalar) in self.state.items():
            val = env[name]
            if scalar:
                bits = (_as_sbit(val),)
            else:
                if not _is_svec(val):
                    raise _Bail("state array became non-array")
                bits = val[1]
            if len(bits) != nbits:
                raise _Bail("state shape changed")
            for k, sb in enumerate(bits):
                sb = _as_sbit(sb)
                c[base + k] = decode(sb, M[base + k], B[base + k])

        outs = []
        for name, site in self.out_writes.items():
            (b_off, sb), = site.items()
            rs = np.zeros((n_s,), dtype=np.uint8)
            rx = np.zeros((n_x,), dtype=np.uint8)
            oc = decode(sb, rs, rx)
            outs.append((name, b_off, rs, rx, oc))
        if set(self.out_writes) != self.out_names:
            raise _Bail("output array not written this subrange")
        return _IterMap(self, M, B, c, outs)


class _IterMap:
    """The extracted per-iteration affine map plus site metadata."""

    def __init__(self, sym: _Sym, M, B, c, outs):
        self.state = dict(sym.state)
        self.n_state = sym.n_state
        self.in_order = list(sym.in_order)
        self.M, self.B, self.c = M, B, c
        self.outs = outs

    def compose(self, K: int):
        """Fold K iterations: returns (MK, Xc, cK, out_rows) where Xc
        maps the K*n_x per-iteration input bits (iteration-major) into
        the final state, and out_rows[site] = (Ow (K,n_s), Pw (K,K*nx),
        qw (K,)) gives each iteration's emitted bit."""
        n_s, n_x = self.n_state, len(self.in_order)
        A_ = np.eye(n_s, dtype=np.uint8)
        X = np.zeros((n_s, K * n_x), dtype=np.uint8)
        C = np.zeros((n_s,), dtype=np.uint8)
        rows = [(np.zeros((K, n_s), np.uint8),
                 np.zeros((K, K * n_x), np.uint8),
                 np.zeros((K,), np.uint8)) for _ in self.outs]
        for i in range(K):
            for t, (_n, _b, rs, rx, oc) in enumerate(self.outs):
                Ow, Pw, qw = rows[t]
                Ow[i] = (rs @ A_) % 2
                Pw[i] = (rs @ X) % 2
                Pw[i, i * n_x:(i + 1) * n_x] ^= rx
                qw[i] = (int(rs @ C) + int(oc)) % 2
            A_ = (self.M @ A_) % 2
            X = (self.M @ X) % 2
            X[:, i * n_x:(i + 1) * n_x] ^= self.B
            C = ((self.M @ C) + self.c) % 2
        return A_, X, C, rows


# --------------------------------------------------------------------------
# Planner: range splitting to branch-constant subranges
# --------------------------------------------------------------------------


def _free(e) -> Set[str]:
    from .eval import _free_names
    return _free_names(e)


def _plan(st: A.SFor, scope, ctx, start: int,
          count_static: Optional[int]):
    """Split [start, start+count) at discovered loop-var comparison
    crossings until every subrange symbolically executes with constant
    branch decisions (or bails). Returns [(lo, hi_static_or_None,
    itermap_or_None), ...] where hi of the last subrange is None
    (bounded by the possibly-traced loop end)."""
    bps: Set[int] = set()
    for _ in range(_MAX_SPLITS):
        pts = sorted(b for b in bps
                     if b > start
                     and (count_static is None
                          or b < start + count_static))
        bounds = [start] + pts
        plans = []
        new_bps: Set[int] = set()
        for i, lo in enumerate(bounds):
            hi = bounds[i + 1] if i + 1 < len(bounds) else None
            sym = _Sym(st, scope, ctx, p_rep=lo)
            try:
                im = sym.run()
            except _Bail:
                im = None
            new_bps |= sym.breakpoints
            plans.append((lo, hi, im))
        if new_bps <= bps:
            return plans
        bps |= new_bps
    raise _Bail("range splitting did not converge")


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------


def gf2_for(start, count, st: A.SFor, scope, ctx) -> bool:
    """Try to run `for var in [start, count] body` as composed GF(2)
    block steps. Returns True when it fully handled the loop (state
    and outputs updated); False leaves all state untouched. The port's
    device loops always have static bounds (a bound that differs per
    firing raised before), so every subrange is static."""
    try:
        start_i = int(start)
        count_static = int(count)
    except Exception:
        return False
    if count_static < 2 * K_BLOCK:
        return False         # nothing to win

    try:
        plans = _plan(st, scope, ctx, start_i, count_static)
    except _Bail:
        return False

    # worthwhile only if the open-ended (or a long static) subrange
    # compressed; otherwise let the ordinary device loop handle it all
    last_ok = plans[-1][2] is not None
    any_long_static = any(
        im is not None and hi is not None and hi - lo >= 2 * K_BLOCK
        for lo, hi, im in plans)
    if not (last_ok or any_long_static):
        return False

    from .eval import ANALYSIS_GAPS, _staged_for

    end = start_i + count_static

    # snapshot every mutable cell before committing any subrange: an
    # analysis gap surfacing as a shape/dtype error at execution time
    # must restore state and fall back to the ordinary device loop
    # (same discipline as _vectorized_for); a program error or a
    # device fault propagates
    snap = [(c, c.value) for _n, c in scope.mutable_cells_named()]
    try:
        for lo, hi, im in plans:
            sub_hi = end if hi is None else hi
            sub_len = max(0, int(sub_hi - lo))
            if sub_len == 0:
                continue
            if im is None or sub_len < 2 * K_BLOCK:
                _staged_for(lo, sub_len, st, scope, ctx, try_gf2=False)
                continue
            _run_compressed(im, lo, sub_len, st, scope, ctx)
    except (_Bail,) + ANALYSIS_GAPS:
        for c, v in snap:
            c.value = v
        return False
    return True


def _find_writable(scope, name):
    """The WRITE-THROUGH cell for `name`. `scope.find` may hand back a
    snapshot view (elab's RuntimeScope wraps ir.Env refs in throwaway
    Cells); `mutable_cells_named` is the channel the ordinary device
    loop writes back through, innermost-first."""
    for n, c in scope.mutable_cells_named():
        if n == name:
            return c
    return scope.find(name)


def _run_compressed(im: _IterMap, lo, sub_len, st, scope, ctx) -> None:
    from .eval import _dev, _dyn_slice, _dyn_update_slice, _staged_for, _t
    from ziria_tpu_torch.ops.cplx import exact_fp32

    K = K_BLOCK
    n_s, n_x = im.n_state, len(im.in_order)
    MK, X, cK, rows = im.compose(K)

    # group input sites per array into contiguous windows
    arrays: Dict[str, List[int]] = {}
    for (name, b) in im.in_order:
        arrays.setdefault(name, []).append(b)
    win: Dict[str, Tuple[int, int, int]] = {}   # name -> (bmin, W, col0)
    col0 = 0
    for name, bs in arrays.items():
        bmin, bmax = min(bs), max(bs)
        W = K + (bmax - bmin)
        win[name] = (bmin, W, col0)
        col0 += W
    W_total = col0

    def remap(mat_x):
        """(r, K*n_x) iteration-major input coefficients -> (r, W_total)
        window coordinates (coefficients on a shared column XOR)."""
        out = np.zeros(mat_x.shape[:-1] + (W_total,), dtype=np.uint8)
        for i in range(K):
            for j, (name, b) in enumerate(im.in_order):
                bmin, _W, c0 = win[name]
                col = c0 + i + (b - bmin)
                out[..., col] ^= mat_x[..., i * n_x + j]
        return out

    BW = remap(X)
    out_mats = []
    for (name, b_off, _rs, _rx, _oc), (Ow, Pw, qw) in zip(im.outs, rows):
        out_mats.append((name, b_off, Ow, remap(Pw), qw))

    dev = _dev()

    def as_f32(a):
        return torch.from_numpy(np.asarray(a, np.float32, order="C")).to(dev)

    MKj, BWj, cKj = as_f32(MK), as_f32(BW), as_f32(cK)
    out_j = [(name, b, as_f32(Ow), as_f32(PW), as_f32(qw))
             for name, b, Ow, PW, qw in out_mats]

    # gather state entry vector (0/1 values in float32)
    cells = {name: _find_writable(scope, name) for name in im.state}
    parts = []
    for name, (base, nbits, scalar) in sorted(
            im.state.items(), key=lambda kv: kv[1][0]):
        v = _t(cells[name].value, dev)
        parts.append(v.reshape((nbits,)).to(torch.float32))
    s = torch.cat(parts) if parts else torch.zeros((0,), device=dev)

    in_vals = {name: _t(scope.find(name).value, dev) for name in arrays}
    out_cells = {name: _find_writable(scope, name) for name, *_ in out_j}
    bufs = [_t(out_cells[name].value, dev) for name, *_ in out_j]

    nblocks = sub_len // K
    in_names = list(arrays)

    with exact_fp32():
        for j in range(nblocks):
            p0 = lo + j * K
            if W_total:
                x = torch.cat([
                    _dyn_slice(in_vals[name], p0 + win[name][0],
                               win[name][1]).to(torch.float32)
                    for name in in_names])
                s2 = torch.fmod(MKj @ s + BWj @ x + cKj, 2.0)
            else:
                x = None
                s2 = torch.fmod(MKj @ s + cKj, 2.0)
            new_bufs = []
            for (name, b_off, Ow, PW, qw), buf in zip(out_j, bufs):
                y = Ow @ s + qw
                if x is not None:
                    y = y + PW @ x
                y = torch.fmod(y, 2.0).to(buf.dtype)
                new_bufs.append(_dyn_update_slice(buf, y, p0 + b_off))
            s, bufs = s2, new_bufs
    for (name, *_), buf in zip(out_j, bufs):
        out_cells[name].value = buf
    for name, (base, nbits, scalar) in im.state.items():
        piece = s[base:base + nbits].to(torch.uint8)
        cells[name].value = piece[0] if scalar else piece

    # remainder tail: the original body, on the ordinary device loop
    tail_lo = lo + nblocks * K
    tail_n = sub_len - nblocks * K
    if tail_n:
        _staged_for(tail_lo, tail_n, st, scope, ctx, try_gf2=False)
