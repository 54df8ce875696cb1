"""Static expression-level typechecker for the surface language (port copy of
ziria_tpu/frontend/typecheck.py, which imports no JAX).

Counterpart of the reference's ``TcExpr.hs``/``TcUnify.hs``/``TcComp.hs``
(SURVEY.md §2.1 typechecker row): dtype and array-length checking at
elaboration time, with located errors, so a `.zir` program with a wrong
array length, a bit/complex mismatch, or a bad ext-function call is
rejected before anything runs — previously these exploded at runtime
inside frontend/eval.py (VERDICT round 1, missing #3).

Design notes (TPU-first, not a Haskell port):

* The checker runs over the *surface AST* after `Elaborator.elaborate()`
  has registered structs/funs/exts and evaluated top-level `let`s, so
  global types are derived from actual values (an `arr[64]` table really
  has 64 elements) and array-length expressions are folded with the same
  static evaluator the elaborator uses — one arithmetic, two clients.
* Unknown is a first-class type: stream items bound by bare `take` are
  untyped here (stream typing is core/types.py's job), so the checker is
  *sound on what it knows* and silent where it knows nothing. Annotated
  binds (`(x : arr[64] complex16) <- takes 64`) get full checking.
* Numeric discipline is C-like where the evaluator is C-like (implicit
  int width changes wrap, int→double widens) and strict where silent
  coercion would corrupt data: complex→real, real→int-from-double,
  scalar→array and array-length mismatches are compile-time errors,
  matching the reference's no-implicit-casts spirit without breaking
  the evaluator's documented static-scalar laxity.
* Comp functions are checked at each call site with the actual argument
  types (the checker "inlines" like elab does), so lengths flow through
  `fun comp` parameters exactly as they will at elaboration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ziria_tpu_torch.frontend import ast as A
from ziria_tpu_torch.frontend import eval as E


from ziria_tpu_torch.frontend.elab import ElabError


class ZiriaTypeError(ElabError):
    """A located static type error (src:line:col: message).

    Subclasses ElabError so callers treating "the program failed to
    compile" uniformly (CLI, tests) keep working; catch ZiriaTypeError
    specifically to distinguish type errors from structural ones."""


# --------------------------------------------------------------------------
# Checked types
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TcTy:
    def show(self) -> str:
        return "?"


@dataclass(frozen=True)
class Unknown(TcTy):
    def show(self) -> str:
        return "?"


@dataclass(frozen=True)
class Unit(TcTy):
    def show(self) -> str:
        return "unit"


@dataclass(frozen=True)
class Str(TcTy):
    def show(self) -> str:
        return "string"


@dataclass(frozen=True)
class Base(TcTy):
    """A scalar base type. ``weak`` marks compile-time-static values
    (literals, fold results) that adapt to any numeric context, mirroring
    the evaluator's static-scalar policy (eval.py module docstring)."""

    name: str
    weak: bool = False

    def show(self) -> str:
        return self.name


@dataclass(frozen=True)
class Arr(TcTy):
    elem: TcTy
    n: Optional[int]          # None = unknown / length-polymorphic

    def show(self) -> str:
        ln = "" if self.n is None else str(self.n)
        return f"arr[{ln}] {self.elem.show()}"


@dataclass(frozen=True)
class Struct(TcTy):
    name: str

    def show(self) -> str:
        return self.name


UNKNOWN = Unknown()
UNIT = Unit()
STRING = Str()
BOOL = Base("bool")

# numeric kind lattice: bit < int < double < complex
_KIND = {"bit": 0, "bool": 0, "int8": 1, "int16": 1, "int32": 1,
         "int64": 1, "int": 1, "double": 2,
         "complex": 3, "complex16": 3, "complex32": 3}
_INT_RANK = {"bit": 0, "int8": 1, "int16": 2, "int32": 3, "int": 3,
             "int64": 4}


def _kind(t: Base) -> int:
    return _KIND[t.name]


def _is_int(t: Base) -> bool:
    return t.name in _INT_RANK


def _np_base_name(dt) -> str:
    dt = np.dtype(dt)
    if dt == np.uint8:
        return "bit"
    if dt == np.bool_:
        return "bool"
    if dt.kind == "i":
        return f"int{dt.itemsize * 8}"
    if dt.kind == "f":
        return "double"
    if dt.kind == "c":
        return "complex"
    if dt.kind == "u":
        return f"int{dt.itemsize * 8}"   # unsigned: treat as int kind
    raise ValueError(f"no base type for dtype {dt}")


def type_of_value(v: Any) -> TcTy:
    """Derive a checked type from a runtime value (global lets)."""
    if v is None:
        return UNIT
    if isinstance(v, str):
        return STRING
    if isinstance(v, dict):
        return Struct(v.get("__struct__", "?"))
    if isinstance(v, bool):
        return Base("bool", weak=True)
    if isinstance(v, int):
        return Base("int", weak=True)
    if isinstance(v, float):
        return Base("double", weak=True)
    if isinstance(v, complex):
        return Base("complex", weak=True)
    if hasattr(v, "dtype"):
        shape = np.shape(v)
        try:
            base = Base(_np_base_name(v.dtype))
        except ValueError:
            return UNKNOWN
        if not shape:
            return base
        t: TcTy = base
        for n in reversed(shape[1:]):
            t = Arr(t, int(n))
        return Arr(t, int(shape[0]))
    return UNKNOWN


# --------------------------------------------------------------------------
# Assignability / joins
# --------------------------------------------------------------------------


def assignable(dst: TcTy, src: TcTy) -> bool:
    """May a value of type `src` flow into a slot of type `dst` without
    an explicit cast? Unknown is compatible with everything."""
    if isinstance(dst, Unknown) or isinstance(src, Unknown):
        return True
    if isinstance(dst, Str) or isinstance(src, Str):
        return isinstance(dst, Str) and isinstance(src, Str)
    if isinstance(dst, Unit) or isinstance(src, Unit):
        return isinstance(dst, Unit) and isinstance(src, Unit)
    if isinstance(dst, Base) and isinstance(src, Base):
        if src.weak:
            return True               # static scalars adapt (eval policy)
        kd, ks = _kind(dst), _kind(src)
        if dst.name == "bool":
            return ks <= 1            # C-ish: int/bit into bool
        if ks <= 1 and kd <= 1:
            return True               # any int width ↔ any int width/bit
        return ks <= kd               # widening only across kinds
    if isinstance(dst, Arr) and isinstance(src, Arr):
        if dst.n is not None and src.n is not None and dst.n != src.n:
            return False
        return assignable(dst.elem, src.elem)
    if isinstance(dst, Arr) != isinstance(src, Arr):
        return False                  # scalar↔array never implicit
    if isinstance(dst, Struct) and isinstance(src, Struct):
        return dst.name == src.name or src.name == "?"
    return False


def join(a: TcTy, b: TcTy) -> TcTy:
    """Least common type of two branches (if/cond arms)."""
    if isinstance(a, Unknown) or isinstance(b, Unknown):
        return UNKNOWN
    if a == b:
        return a
    if isinstance(a, Base) and isinstance(b, Base):
        if a.weak and not b.weak:
            return b if assignable(b, a) else _wider(a, b)
        if b.weak and not a.weak:
            return a if assignable(a, b) else _wider(a, b)
        return _wider(a, b)
    if isinstance(a, Arr) and isinstance(b, Arr):
        n = a.n if a.n == b.n else (a.n if b.n is None else
                                    (b.n if a.n is None else None))
        if a.n is not None and b.n is not None and a.n != b.n:
            return UNKNOWN            # caller checks lengths explicitly
        return Arr(join(a.elem, b.elem), n)
    return UNKNOWN


def _wider(a: Base, b: Base) -> Base:
    ka, kb = _kind(a), _kind(b)
    if ka != kb:
        return a if ka > kb else b
    if _is_int(a) and _is_int(b):
        return a if _INT_RANK[a.name] >= _INT_RANK[b.name] else b
    return a


# --------------------------------------------------------------------------
# Scope
# --------------------------------------------------------------------------


@dataclass
class VarInfo:
    ty: TcTy
    mutable: bool


class TcScope:
    def __init__(self, parent: Optional["TcScope"] = None):
        self.vars: Dict[str, VarInfo] = {}
        self.parent = parent

    def child(self) -> "TcScope":
        return TcScope(self)

    def declare(self, name: str, ty: TcTy, mutable: bool) -> None:
        self.vars[name] = VarInfo(ty, mutable)

    def find(self, name: str) -> Optional[VarInfo]:
        s: Optional[TcScope] = self
        while s is not None:
            v = s.vars.get(name)
            if v is not None:
                return v
            s = s.parent
        return None


# --------------------------------------------------------------------------
# The checker
# --------------------------------------------------------------------------


_ARITH = ("+", "-", "*", "/", "**")
_CMP_ORD = ("<", "<=", ">", ">=")
_CMP_EQ = ("==", "!=")
_BITS = ("&", "|", "^")
_SHIFT = ("<<", ">>")
_LOGIC = ("&&", "||")


class TypeChecker:
    """Walks a surface `Program` using the elaborator's registries.

    `elab` is a `frontend.elab.Elaborator` that has already run
    `.elaborate()` — structs/funs/exts registered, top-level lets
    evaluated into `gscope`."""

    def __init__(self, elab):
        self.elab = elab
        self.src = elab.src
        self.structs: Dict[str, E.StructDef] = elab.ctx.structs
        self.funs = elab.ctx.funs
        self.ext_sigs = elab.ext_sigs
        self.exts = elab.ctx.exts
        self.comp_funs = elab.comp_funs
        self._fun_sigs: Dict[str, Tuple[List[TcTy], TcTy]] = {}
        self._comp_stack: List[str] = []
        self._checked_funs: set = set()
        # under the fixed-point policy, complex16 components are ints
        self.fxp = getattr(elab.ctx, "fxp_complex16", False)

    # ------------------------------------------------------------- errors

    def err(self, loc, msg: str) -> ZiriaTypeError:
        return ZiriaTypeError(f"{self.src}:{loc[0]}:{loc[1]}: {msg}")

    # -------------------------------------------------------- type resolve

    def _static_int(self, e: Optional[A.Expr]) -> Optional[int]:
        """Fold `e` to a static int against the global scope, or None."""
        if e is None:
            return None
        if isinstance(e, A.EInt):
            return e.val
        from ziria_tpu_torch.frontend.elab import ElabEnv
        ok, v = self.elab.try_st_eval(e, ElabEnv(self.elab.gscope))
        if ok and isinstance(v, (int, np.integer)) \
                and not isinstance(v, bool):
            return int(v)
        return None

    def resolve_ty(self, ty: Optional[A.Ty], loc=(0, 0)) -> TcTy:
        if ty is None:
            return UNKNOWN
        if isinstance(ty, A.TBase):
            if ty.name == "unit":
                return UNIT
            if ty.name not in _KIND:
                raise self.err(loc, f"unknown base type {ty.name!r}")
            return Base(ty.name)
        if isinstance(ty, A.TArr):
            return Arr(self.resolve_ty(ty.elem, loc), self._static_int(ty.n))
        if isinstance(ty, A.TStruct):
            if ty.name not in self.structs:
                raise self.err(loc, f"unknown struct type {ty.name!r}")
            return Struct(ty.name)
        raise self.err(loc, f"unknown type {ty}")

    # -------------------------------------------------------- entry points

    def check_program(self) -> None:
        # expression fun bodies, in declaration order
        for name, fd in self.funs.items():
            self._check_fun(name, fd.decl)
        # ext declarations were already resolved against the registry by
        # elaborate(); nothing further to check until call sites.
        for name, cast in self.elab.top_comp_asts.items():
            self.check_comp(cast, TcScope())

    def _check_fun(self, name: str, d: A.DFun) -> None:
        if name in self._checked_funs:
            return
        self._checked_funs.add(name)
        scope = TcScope()
        ptys = []
        for p in d.params:
            t = self.resolve_ty(p.ty, p.loc)
            ptys.append(t)
            scope.declare(p.name, t, mutable=False)
        ret = self.resolve_ty(d.ret_ty, d.loc)
        self._fun_sigs[name] = (ptys, ret)
        got = self.check_stmts(d.body, scope)
        if d.ret_ty is not None and not isinstance(got, (Unknown, Unit)) \
                and not assignable(ret, got):
            raise self.err(d.loc,
                           f"fun {name}: returns {got.show()} but is "
                           f"declared : {ret.show()}")

    # -------------------------------------------------------- statements

    def check_stmts(self, stmts, scope: TcScope) -> TcTy:
        """Check a statement block; result = type of `return`s (joined),
        Unit when the block cannot return a value."""
        ret: TcTy = UNIT
        for st in stmts:
            r = self.check_stmt(st, scope)
            if r is not None:
                ret = r if isinstance(ret, Unit) else join(ret, r)
        return ret

    def check_stmt(self, st: A.Stmt, scope: TcScope) -> Optional[TcTy]:
        if isinstance(st, A.SVar):
            if st.ty is None:
                raise self.err(st.loc, "var needs a type annotation")
            ty = self.resolve_ty(st.ty, st.loc)
            if st.init is not None:
                it = self.infer(st.init, scope)
                self._require(ty, it, st.loc,
                              f"var {st.name} : {ty.show()}")
            scope.declare(st.name, ty, mutable=True)
            return None
        if isinstance(st, A.SLet):
            it = self.infer(st.e, scope)
            if st.ty is not None:
                ty = self.resolve_ty(st.ty, st.loc)
                self._require(ty, it, st.loc,
                              f"let {st.name} : {ty.show()}")
            else:
                ty = it
            scope.declare(st.name, ty, mutable=False)
            return None
        if isinstance(st, A.SAssign):
            self._check_assign(st.lval, self.infer(st.e, scope), scope,
                               st.loc)
            return None
        if isinstance(st, A.SIf):
            self._require_cond(st.c, scope)
            a = self.check_stmts(st.then, scope.child())
            b = self.check_stmts(st.els, scope.child())
            out = None
            for r in (a, b):
                if not isinstance(r, Unit):
                    out = r if out is None else join(out, r)
            return out
        if isinstance(st, A.SFor):
            self._require_int(st.start, scope, "for start")
            self._require_int(st.count, scope, "for count")
            s = scope.child()
            s.declare(st.var, Base("int", weak=True), mutable=False)
            r = self.check_stmts(st.body, s)
            return None if isinstance(r, Unit) else r
        if isinstance(st, A.SWhile):
            self._require_cond(st.c, scope)
            r = self.check_stmts(st.body, scope.child())
            return None if isinstance(r, Unit) else r
        if isinstance(st, A.SReturn):
            return self.infer(st.e, scope)
        if isinstance(st, A.SExpr):
            self.infer(st.e, scope)
            return None
        raise self.err(st.loc, f"unknown statement {type(st).__name__}")

    def _check_assign(self, lval: A.Expr, vt: TcTy, scope: TcScope,
                      loc) -> None:
        root = lval
        while isinstance(root, (A.EIdx, A.ESlice, A.EField)):
            root = root.arr if hasattr(root, "arr") and root.arr is not None \
                else root.e
        if isinstance(root, A.EVar):
            info = scope.find(root.name)
            if info is not None and not info.mutable:
                raise self.err(
                    loc, f"assignment to immutable binding {root.name!r} "
                         f"(declare it with `var`)")
        if isinstance(lval, A.EVar):
            info = scope.find(lval.name)
            if info is None:
                # stream-level vars are visible to do-blocks through the
                # runtime env; the comp walker pre-declares them, so an
                # unknown name here is either global (immutable) or unbound
                gv = self._global_type(lval.name)
                if gv is not None:
                    raise self.err(loc, f"assignment to immutable "
                                        f"binding {lval.name!r}")
                raise self.err(loc,
                               f"assignment to unbound variable "
                               f"{lval.name!r}")
            self._require(info.ty, vt, loc, f"{lval.name} := ...")
            return
        if isinstance(lval, A.EIdx):
            at = self.infer(lval.arr, scope)
            self._require_int(lval.i, scope, "array index")
            self._static_bounds(lval.i, at, lval.loc)
            if isinstance(at, Arr):
                self._require(at.elem, vt, loc, "element assignment")
            elif isinstance(at, Base):
                raise self.err(lval.loc, "cannot index a scalar")
            return
        if isinstance(lval, A.ESlice):
            at = self.infer(lval.arr, scope)
            self._require_int(lval.i, scope, "slice offset")
            n = self._static_int(lval.n)
            if isinstance(at, Arr):
                self._slice_bounds(lval, at, n)
                if isinstance(vt, Arr):
                    if n is not None and vt.n is not None and vt.n != n:
                        raise self.err(
                            loc, f"slice of length {n} assigned from "
                                 f"array of length {vt.n}")
                    self._require(at.elem, vt.elem, loc, "slice assignment")
                else:
                    self._require(at.elem, vt, loc, "slice assignment")
            elif isinstance(at, Base):
                raise self.err(lval.loc, "cannot slice a scalar")
            return
        if isinstance(lval, A.EField):
            et = self.infer(lval.e, scope)
            ft = self._field_type(et, lval.f, lval.loc)
            self._require(ft, vt, loc, f".{lval.f} assignment")
            return
        raise self.err(getattr(lval, "loc", loc),
                       f"invalid assignment target "
                       f"{type(lval).__name__}")

    # -------------------------------------------------------- expressions

    def infer(self, e: Optional[A.Expr], scope: TcScope) -> TcTy:
        if e is None:
            return UNKNOWN
        if isinstance(e, A.EInt):
            return Base("int", weak=True)
        if isinstance(e, A.EFloat):
            return Base("double", weak=True)
        if isinstance(e, A.EBit):
            return Base("bit", weak=True)
        if isinstance(e, A.EBool):
            return Base("bool", weak=True)
        if isinstance(e, A.EString):
            return STRING
        if isinstance(e, A.EVar):
            info = scope.find(e.name)
            if info is not None:
                return info.ty
            g = self._global_type(e.name)
            if g is not None:
                return g
            raise self.err(e.loc, f"unbound variable {e.name!r}")
        if isinstance(e, A.EUn):
            t = self.infer(e.e, scope)
            return self._check_unary(e, t)
        if isinstance(e, A.EBin):
            return self._check_binop(e, scope)
        if isinstance(e, A.ECond):
            self._require_cond(e.c, scope)
            a = self.infer(e.a, scope)
            b = self.infer(e.b, scope)
            if isinstance(a, Arr) and isinstance(b, Arr) \
                    and a.n is not None and b.n is not None and a.n != b.n:
                raise self.err(e.loc,
                               f"if-expression arms have different "
                               f"lengths ({a.n} vs {b.n})")
            if not (assignable(a, b) or assignable(b, a)):
                raise self.err(e.loc,
                               f"if-expression arms disagree: "
                               f"{a.show()} vs {b.show()}")
            return join(a, b)
        if isinstance(e, A.ECall):
            return self._check_call(e, scope)
        if isinstance(e, A.EIdx):
            at = self.infer(e.arr, scope)
            self._require_int(e.i, scope, "array index")
            if isinstance(at, Arr):
                self._static_bounds(e.i, at, e.loc)
                return at.elem
            if isinstance(at, (Base, Struct)):
                raise self.err(e.loc, f"cannot index a "
                                      f"{'scalar' if isinstance(at, Base) else 'struct'}")
            return UNKNOWN
        if isinstance(e, A.ESlice):
            at = self.infer(e.arr, scope)
            self._require_int(e.i, scope, "slice offset")
            n = self._static_int(e.n)
            if isinstance(at, Arr):
                self._slice_bounds(e, at, n)
                return Arr(at.elem, n)
            if isinstance(at, (Base, Struct)):
                raise self.err(e.loc, "cannot slice a non-array value")
            return Arr(UNKNOWN, n)
        if isinstance(e, A.EField):
            return self._field_type(self.infer(e.e, scope), e.f, e.loc)
        if isinstance(e, A.EArrLit):
            ts = [self.infer(x, scope) for x in e.elems]
            elem: TcTy = UNKNOWN
            for t in ts:
                if isinstance(t, (Arr, Struct, Str, Unit)):
                    elem = t if isinstance(elem, Unknown) else elem
                    continue
                elem = t if isinstance(elem, Unknown) else join(elem, t)
            return Arr(elem, len(e.elems))
        if isinstance(e, A.EStructLit):
            sd = self.structs.get(e.name)
            if sd is None:
                raise self.err(e.loc, f"unknown struct {e.name!r}")
            given = {fn: fe for fn, fe in e.fields}
            for fn, fty in sd.fields:
                if fn not in given:
                    raise self.err(e.loc,
                                   f"struct {e.name} literal missing "
                                   f"field {fn!r}")
                ft = self.resolve_ty(fty, e.loc)
                self._require(ft, self.infer(given.pop(fn), scope),
                              e.loc, f"field {fn} of struct {e.name}")
            if given:
                extra = sorted(given)
                raise self.err(e.loc,
                               f"struct {e.name} has no field "
                               f"{extra[0]!r}")
            return Struct(e.name)
        raise self.err(getattr(e, "loc", (0, 0)),
                       f"unknown expression node {type(e).__name__}")

    # ---------------------------------------------------------- operators

    def _check_unary(self, e: A.EUn, t: TcTy) -> TcTy:
        if isinstance(t, (Unknown,)):
            return UNKNOWN
        base = t.elem if isinstance(t, Arr) else t
        if isinstance(base, Unknown):
            return t
        if not isinstance(base, Base):
            raise self.err(e.loc, f"unary {e.op} on {t.show()}")
        if e.op == "-":
            if base.name == "bool":
                raise self.err(e.loc, "unary - on bool")
        elif e.op == "~":
            if not _is_int(base):
                raise self.err(e.loc, f"bitwise ~ needs an integer "
                                      f"operand, got {base.show()}")
        elif e.op == "!":
            if _kind(base) >= 2:
                raise self.err(e.loc, f"logical ! on {base.show()}")
            return BOOL if not isinstance(t, Arr) else Arr(BOOL, t.n)
        return t

    def _check_binop(self, e: A.EBin, scope: TcScope) -> TcTy:
        op = e.op
        ta = self.infer(e.a, scope)
        tb = self.infer(e.b, scope)
        if isinstance(ta, Unknown) or isinstance(tb, Unknown):
            if op in _CMP_ORD + _CMP_EQ + _LOGIC:
                return BOOL
            return UNKNOWN
        for t in (ta, tb):
            if isinstance(t, (Struct, Str, Unit)):
                raise self.err(e.loc, f"operator {op} on {t.show()}")

        # element/length handling for array operands
        n_out: Optional[int] = None
        arr_out = False
        if isinstance(ta, Arr) or isinstance(tb, Arr):
            arr_out = True
            if isinstance(ta, Arr) and isinstance(tb, Arr):
                if ta.n is not None and tb.n is not None and ta.n != tb.n:
                    raise self.err(
                        e.loc, f"operator {op} on arrays of different "
                               f"lengths ({ta.n} vs {tb.n})")
                n_out = ta.n if ta.n is not None else tb.n
            else:
                n_out = ta.n if isinstance(ta, Arr) else tb.n
        ba = ta.elem if isinstance(ta, Arr) else ta
        bb = tb.elem if isinstance(tb, Arr) else tb
        if isinstance(ba, Unknown) or isinstance(bb, Unknown):
            return Arr(UNKNOWN, n_out) if arr_out else UNKNOWN
        assert isinstance(ba, Base) and isinstance(bb, Base)

        def out(base: Base) -> TcTy:
            if arr_out:
                return Arr(Base(base.name), n_out)
            return base

        if op in _LOGIC:
            for b in (ba, bb):
                if _kind(b) >= 2:
                    raise self.err(e.loc, f"{op} on {b.show()}")
            return out(BOOL)
        if op in _CMP_EQ:
            if (_kind(ba) == 3) != (_kind(bb) == 3) and \
                    not (ba.weak or bb.weak):
                raise self.err(e.loc,
                               f"comparison {op} between {ba.show()} "
                               f"and {bb.show()}")
            return out(BOOL)
        if op in _CMP_ORD:
            for b in (ba, bb):
                if _kind(b) == 3:
                    raise self.err(e.loc, f"ordering {op} on complex "
                                          f"values")
            return out(BOOL)
        if op in _SHIFT:
            if not _is_int(ba) or not _is_int(bb):
                bad = ba if not _is_int(ba) else bb
                raise self.err(e.loc, f"shift {op} needs integer "
                                      f"operands, got {bad.show()}")
            return out(_result_base(ba, bb))
        if op in _BITS:
            if ba.name == "bool" and bb.name == "bool":
                return out(BOOL)
            for b in (ba, bb):
                if not _is_int(b) and b.name != "bool":
                    raise self.err(e.loc, f"bitwise {op} on {b.show()}")
            return out(_result_base(ba, bb))
        if op == "%":
            for b in (ba, bb):
                if _kind(b) == 3:
                    raise self.err(e.loc, "% on complex values")
            return out(_result_base(ba, bb))
        if op in _ARITH:
            for b in (ba, bb):
                if b.name == "bool":
                    raise self.err(e.loc, f"arithmetic {op} on bool")
            return out(_result_base(ba, bb))
        raise self.err(e.loc, f"unknown operator {op!r}")

    # -------------------------------------------------------------- calls

    def _check_call(self, e: A.ECall, scope: TcScope) -> TcTy:
        name = e.name
        args = list(e.args)
        # casts / complex constructors
        if name in E._BASE_TYPE_NAMES:
            if name in E._CPLX and len(args) == 2:
                for a in args:
                    t = self.infer(a, scope)
                    self._numeric_only(t, a, f"{name}() component")
                return Base(name)
            if len(args) != 1:
                raise self.err(e.loc, f"cast {name} takes one argument")
            t = self.infer(args[0], scope)
            self._numeric_only(t, args[0], f"cast to {name}")
            if isinstance(t, Arr):
                return Arr(Base(name), t.n)
            return Base(name)
        # print family: any printable args
        if name in ("print", "println", "error"):
            for a in args:
                self.infer(a, scope)
            return UNIT
        # user fun
        fd = self.funs.get(name)
        if fd is not None:
            self._check_fun(name, fd.decl)
            ptys, ret = self._fun_sigs[name]
            self._check_args(name, fd.decl.params, ptys, args, scope,
                             e.loc)
            return ret
        # declared ext
        sig = self.ext_sigs.get(name)
        if sig is not None:
            ptys = [self.resolve_ty(p.ty, p.loc) for p in sig.params]
            self._check_args(name, sig.params, ptys, args, scope, e.loc)
            return self.resolve_ty(sig.ret_ty, sig.loc)
        # builtins (length/abs/min/max/sum) — typed structurally
        if name in self.exts:
            return self._check_builtin(name, args, scope, e.loc)
        raise self.err(e.loc, f"unknown function {name!r}")

    def _check_args(self, name, params, ptys, args, scope, loc) -> None:
        if len(args) != len(params):
            raise self.err(loc, f"{name}: expected {len(params)} "
                                f"argument(s), got {len(args)}")
        for p, pt, a in zip(params, ptys, args):
            at = self.infer(a, scope)
            if not assignable(pt, at):
                raise self.err(
                    a.loc if a.loc != (0, 0) else loc,
                    f"{name}: argument {p.name!r} expects {pt.show()}, "
                    f"got {at.show()}")

    def _check_builtin(self, name, args, scope, loc) -> TcTy:
        ts = [self.infer(a, scope) for a in args]
        if name == "length":
            if len(ts) != 1:
                raise self.err(loc, "length takes one argument")
            if isinstance(ts[0], Base):
                raise self.err(loc, "length() of a scalar")
            return Base("int", weak=True)
        if name == "sum":
            if len(ts) == 1 and isinstance(ts[0], Arr):
                return ts[0].elem
            return UNKNOWN
        if name == "abs":
            if len(ts) == 1:
                t = ts[0]
                b = t.elem if isinstance(t, Arr) else t
                if isinstance(b, Base) and _kind(b) == 3:
                    b = Base("double")
                    return Arr(b, t.n) if isinstance(t, Arr) else b
                return t
            return UNKNOWN
        if name in ("min", "max") and len(ts) == 2:
            return join(ts[0], ts[1])
        for t, a in zip(ts, args):
            self._numeric_only(t, a, name, allow_arr=True)
        return UNKNOWN

    # ------------------------------------------------------------ helpers

    def _global_type(self, name: str) -> Optional[TcTy]:
        s = self.elab.gscope
        while s is not None:
            c = s.cells.get(name)
            if c is not None:
                return type_of_value(c.value)
            s = s.parent
        return None

    def _field_type(self, t: TcTy, f: str, loc) -> TcTy:
        if isinstance(t, Unknown):
            return UNKNOWN
        if isinstance(t, Struct):
            sd = self.structs.get(t.name)
            if sd is None:
                return UNKNOWN
            for fn, fty in sd.fields:
                if fn == f:
                    return self.resolve_ty(fty, loc)
            raise self.err(loc, f"struct {t.name} has no field {f!r}")
        if f in ("re", "im"):
            b = t.elem if isinstance(t, Arr) else t
            if isinstance(b, Base) and _kind(b) != 3 and not b.weak:
                raise self.err(loc, f".{f} on non-complex {t.show()}")
            d = Base("double")
            if self.fxp and isinstance(b, Base) and b.name == "complex16":
                d = Base("int32")      # fixed-point components are ints
            return Arr(d, t.n) if isinstance(t, Arr) else d
        raise self.err(loc, f"no field {f!r} on a non-struct value")

    def _numeric_only(self, t: TcTy, e: A.Expr, what: str,
                      allow_arr: bool = True) -> None:
        if isinstance(t, (Struct, Str, Unit)):
            raise self.err(e.loc, f"{what} applied to {t.show()}")
        if isinstance(t, Arr) and not allow_arr:
            raise self.err(e.loc, f"{what} applied to an array")

    def _require(self, dst: TcTy, src: TcTy, loc, what: str) -> None:
        if not assignable(dst, src):
            if isinstance(dst, Arr) and isinstance(src, Arr) \
                    and dst.n is not None and src.n is not None \
                    and dst.n != src.n:
                raise self.err(loc,
                               f"{what}: array length mismatch "
                               f"(expected {dst.n}, got {src.n})")
            raise self.err(loc, f"{what}: cannot use a {src.show()} "
                                f"value here without an explicit cast "
                                f"(expected {dst.show()})")

    def _require_int(self, e: Optional[A.Expr], scope: TcScope,
                     what: str) -> None:
        if e is None:
            return
        t = self.infer(e, scope)
        b = t.elem if isinstance(t, Arr) else t
        if isinstance(b, Base) and not _is_int(b) and not b.weak \
                and b.name != "bool":
            raise self.err(e.loc, f"{what} must be an integer, "
                                  f"got {b.show()}")
        if isinstance(t, (Struct, Str, Unit)):
            raise self.err(e.loc, f"{what} must be an integer, "
                                  f"got {t.show()}")

    def _require_cond(self, e: Optional[A.Expr], scope: TcScope) -> None:
        if e is None:
            return
        t = self.infer(e, scope)
        b = t.elem if isinstance(t, Arr) else t
        if isinstance(b, Base) and _kind(b) == 3:
            raise self.err(e.loc, "condition cannot be complex-valued")
        if isinstance(t, (Struct, Str)):
            raise self.err(e.loc, f"condition cannot be a {t.show()}")

    def _static_bounds(self, i: Optional[A.Expr], at: TcTy, loc) -> None:
        if not isinstance(at, Arr) or at.n is None:
            return
        iv = self._static_int(i)
        if iv is not None and (iv < 0 or iv >= at.n):
            raise self.err(loc, f"index {iv} out of bounds for array "
                                f"of length {at.n}")

    def _slice_bounds(self, e, at: Arr, n: Optional[int]) -> None:
        if at.n is None or n is None:
            return
        iv = self._static_int(e.i)
        if n > at.n or (iv is not None and (iv < 0 or iv + n > at.n)):
            i_s = "?" if iv is None else str(iv)
            raise self.err(e.loc,
                           f"slice [{i_s}, {n}] out of bounds for array "
                           f"of length {at.n}")

    # ------------------------------------------------------- computations

    def comp_ty(self, c: A.Comp, scope: TcScope) -> TcTy:
        """Check a computation and return the type of its *control value*
        (what `x <- c` binds)."""
        if isinstance(c, A.CTake):
            return UNKNOWN          # stream item type: core/types.py's job
        if isinstance(c, A.CTakes):
            self._require_int(c.n, scope, "takes count")
            return Arr(UNKNOWN, self._static_int(c.n))
        if isinstance(c, A.CEmit):
            self.infer(c.e, scope)
            return UNIT
        if isinstance(c, A.CEmits):
            t = self.infer(c.e, scope)
            if isinstance(t, (Base, Struct, Str)):
                raise self.err(c.loc, f"emits needs an array value, "
                                      f"got {t.show()}")
            return UNIT
        if isinstance(c, A.CReturn):
            return self.infer(c.e, scope)
        if isinstance(c, A.CDo):
            return self.check_stmts(c.body, scope.child())
        if isinstance(c, A.CBind):
            ft = self.comp_ty(c.first, scope)
            if c.var is None:
                return self.comp_ty(c.rest, scope)
            s = scope.child()
            if c.var_ty is not None:
                vt = self.resolve_ty(c.var_ty, c.loc)
                self._require(vt, ft, c.loc, f"{c.var} : {vt.show()} <- ...")
            else:
                vt = ft
            s.declare(c.var, vt, mutable=False)
            return self.comp_ty(c.rest, s)
        if isinstance(c, A.CVarDecl):
            if c.ty is None:
                raise self.err(c.loc, "var needs a type annotation")
            ty = self.resolve_ty(c.ty, c.loc)
            if c.init is not None:
                self._require(ty, self.infer(c.init, scope), c.loc,
                              f"var {c.name} : {ty.show()}")
            s = scope.child()
            s.declare(c.name, ty, mutable=True)
            return self.comp_ty(c.rest, s)
        if isinstance(c, A.CLetDecl):
            t = self.infer(c.e, scope)
            s = scope.child()
            s.declare(c.name, t, mutable=False)
            return self.comp_ty(c.rest, s)
        if isinstance(c, A.CLetComp):
            # the bound comp is checked when referenced (it may rely on
            # binds in scope at the use site exactly as written here)
            self.comp_ty(c.c, scope)
            return self.comp_ty(c.rest, scope)
        if isinstance(c, A.CRepeat):
            self.comp_ty(c.body, scope)
            return UNIT
        if isinstance(c, A.CMap):
            self._check_map(c)
            return UNIT
        if isinstance(c, A.CPipe):
            self.comp_ty(c.up, scope)
            return self.comp_ty(c.down, scope)
        if isinstance(c, A.CIf):
            self._require_cond(c.c, scope)
            a = self.comp_ty(c.then, scope)
            b = self.comp_ty(c.els, scope) if c.els is not None else UNIT
            return join(a, b) if not isinstance(a, Unit) else UNIT
        if isinstance(c, A.CFor):
            self._require_int(c.start, scope, "for start")
            self._require_int(c.count, scope, "for count")
            s = scope.child()
            s.declare(c.var, Base("int", weak=True), mutable=False)
            self.comp_ty(c.body, s)
            return UNIT
        if isinstance(c, A.CTimes):
            self._require_int(c.count, scope, "times count")
            self.comp_ty(c.body, scope)
            return UNIT
        if isinstance(c, A.CWhile):
            self._require_cond(c.c, scope)
            self.comp_ty(c.body, scope)
            return UNIT
        if isinstance(c, A.CUntil):
            self.comp_ty(c.body, scope)
            self._require_cond(c.c, scope)
            return UNIT
        if isinstance(c, A.CCall):
            return self._check_comp_call(c, scope)
        if isinstance(c, (A.CRead, A.CWrite)):
            return UNIT
        raise self.err(getattr(c, "loc", (0, 0)),
                       f"unknown computation {type(c).__name__}")

    def _check_map(self, c: A.CMap) -> None:
        name = c.fname
        fd = self.funs.get(name)
        if fd is not None:
            if len(fd.decl.params) != 1:
                raise self.err(c.loc, f"map {name}: needs a one-argument "
                                      f"function")
            self._check_fun(name, fd.decl)
            return
        if name in self.ext_sigs or name in self.exts:
            return
        raise self.err(c.loc, f"map: unknown function {name!r}")

    def _check_comp_call(self, c: A.CCall, scope: TcScope) -> TcTy:
        name = c.name
        d = self.comp_funs.get(name)
        if d is None:
            # comp bindings (let comp x = ...) were checked in place
            if c.args:
                for a in c.args:
                    self.infer(a, scope)
            return UNKNOWN
        if len(c.args) != len(d.params):
            raise self.err(c.loc, f"{name}: expected {len(d.params)} "
                                  f"argument(s), got {len(c.args)}")
        if name in self._comp_stack:
            return UNKNOWN         # elab rejects recursion with its own msg
        s = TcScope()              # comp funs see globals + params only
        for p, a in zip(d.params, c.args):
            at = self.infer(a, scope)
            if p.ty is not None:
                pt = self.resolve_ty(p.ty, p.loc)
                if not assignable(pt, at):
                    raise self.err(
                        a.loc if a.loc != (0, 0) else c.loc,
                        f"{name}: argument {p.name!r} expects "
                        f"{pt.show()}, got {at.show()}")
                # keep the caller's length when the sig is length-open
                if isinstance(pt, Arr) and pt.n is None \
                        and isinstance(at, Arr):
                    pt = Arr(pt.elem, at.n)
                s.declare(p.name, pt, mutable=False)
            else:
                s.declare(p.name, at, mutable=False)
        self._comp_stack.append(name)
        try:
            return self.comp_ty(d.body, s)
        finally:
            self._comp_stack.pop()

    def check_comp(self, c: A.Comp, scope: TcScope) -> None:
        self.comp_ty(c, scope)


def _result_base(a: Base, b: Base) -> Base:
    ka, kb = _kind(a), _kind(b)
    if a.weak and not b.weak:
        return Base(b.name) if kb >= ka else Base(a.name)
    if b.weak and not a.weak:
        return Base(a.name) if ka >= kb else Base(b.name)
    w = _wider(a, b)
    return Base(w.name)


def check_program(elab) -> None:
    """Entry point: statically check an elaborated program's surface AST.

    Raises ZiriaTypeError (a subclass-independent located error) on the
    first definite type error. Called by Elaborator.build()."""
    TypeChecker(elab).check_program()
