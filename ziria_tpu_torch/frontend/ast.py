"""Surface-syntax AST for the two-level Ziria-style language (port copy of
ziria_tpu/frontend/ast.py, which imports no JAX).

Counterpart of the reference's `AstExpr.hs` / `AstComp.hs` (SURVEY.md
§2.1): one AST for the first-order imperative *expression* language and
one for the *stream computation* language. Deliberately plain Python
dataclasses — the elaborator (frontend/elab.py) turns computation nodes
into the core IR (core/ir.py) and the staged evaluator (frontend/eval.py)
turns expression nodes into numpy and torch values, so these classes carry no
behavior beyond structure + source location.

Every node has a ``loc`` (line, col) for error messages; the parser
fills it in.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

Loc = Tuple[int, int]   # (line, col), 1-based


# --------------------------------------------------------------------------
# Types (surface syntax)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Ty:
    """Base surface type."""


@dataclass(frozen=True)
class TBase(Ty):
    """bit | bool | int8 | int16 | int32 | int64 | int | double |
    complex16 | complex32 | complex | unit"""

    name: str

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class TArr(Ty):
    """arr[n] t — fixed-length array. ``n`` is an expression AST that must
    elaborate to a static int (the reference's array-length arithmetic);
    None means length-polymorphic (only legal in fun params, `arr t`)."""

    n: Optional["Expr"]
    elem: Ty

    def __str__(self):
        return f"arr[{self.n}] {self.elem}"


@dataclass(frozen=True)
class TStruct(Ty):
    """A named struct type (declared with `struct Name = {...}`)."""

    name: str

    def __str__(self):
        return self.name


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    loc: Loc = field(default=(0, 0), compare=False)


@dataclass(frozen=True)
class EInt(Expr):
    val: int = 0


@dataclass(frozen=True)
class EFloat(Expr):
    val: float = 0.0


@dataclass(frozen=True)
class EBit(Expr):
    """'0 or '1 bit literal."""

    val: int = 0


@dataclass(frozen=True)
class EBool(Expr):
    val: bool = False


@dataclass(frozen=True)
class EString(Expr):
    """Only as print/error arguments."""

    val: str = ""


@dataclass(frozen=True)
class EVar(Expr):
    name: str = ""


@dataclass(frozen=True)
class EUn(Expr):
    """Unary: - ! ~"""

    op: str = "-"
    e: Optional[Expr] = None


@dataclass(frozen=True)
class EBin(Expr):
    """Binary: + - * / % ** << >> < <= > >= == != & ^ | && ||"""

    op: str = "+"
    a: Optional[Expr] = None
    b: Optional[Expr] = None


@dataclass(frozen=True)
class ECond(Expr):
    """if c then a else b (expression form)."""

    c: Optional[Expr] = None
    a: Optional[Expr] = None
    b: Optional[Expr] = None


@dataclass(frozen=True)
class ECall(Expr):
    """f(args) — user fun, ext fun, builtin, or a cast when `name` is a
    base-type name (int16(x), double(x), complex16(re, im))."""

    name: str = ""
    args: Tuple[Expr, ...] = ()


@dataclass(frozen=True)
class EIdx(Expr):
    """x[i] — single element."""

    arr: Optional[Expr] = None
    i: Optional[Expr] = None


@dataclass(frozen=True)
class ESlice(Expr):
    """x[i, n] — n elements from offset i; n must be static (the
    reference's slice form, SURVEY.md §0)."""

    arr: Optional[Expr] = None
    i: Optional[Expr] = None
    n: Optional[Expr] = None


@dataclass(frozen=True)
class EField(Expr):
    """x.f — struct field (also .re/.im on complex)."""

    e: Optional[Expr] = None
    f: str = ""


@dataclass(frozen=True)
class EArrLit(Expr):
    """{e1, e2, ...} array literal."""

    elems: Tuple[Expr, ...] = ()


@dataclass(frozen=True)
class EStructLit(Expr):
    """Name { f1 = e1, f2 = e2 } struct literal."""

    name: str = ""
    fields: Tuple[Tuple[str, Expr], ...] = ()


# --------------------------------------------------------------------------
# Statements (imperative bodies: fun bodies and do-blocks)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Stmt:
    loc: Loc = field(default=(0, 0), compare=False)


@dataclass(frozen=True)
class SVar(Stmt):
    """var x : t [:= e]"""

    name: str = ""
    ty: Optional[Ty] = None
    init: Optional[Expr] = None


@dataclass(frozen=True)
class SLet(Stmt):
    """let x [: t] = e — immutable binding."""

    name: str = ""
    ty: Optional[Ty] = None
    e: Optional[Expr] = None


@dataclass(frozen=True)
class SAssign(Stmt):
    """lval := e. `lval` is EVar / EIdx / ESlice / EField chain."""

    lval: Optional[Expr] = None
    e: Optional[Expr] = None


@dataclass(frozen=True)
class SIf(Stmt):
    c: Optional[Expr] = None
    then: Tuple[Stmt, ...] = ()
    els: Tuple[Stmt, ...] = ()


@dataclass(frozen=True)
class SFor(Stmt):
    """for i in [start, len] { body } — reference-style range: `len`
    iterations starting at `start`."""

    var: str = ""
    start: Optional[Expr] = None
    count: Optional[Expr] = None
    body: Tuple[Stmt, ...] = ()


@dataclass(frozen=True)
class SWhile(Stmt):
    c: Optional[Expr] = None
    body: Tuple[Stmt, ...] = ()


@dataclass(frozen=True)
class SReturn(Stmt):
    e: Optional[Expr] = None


@dataclass(frozen=True)
class SExpr(Stmt):
    """Expression statement (a call evaluated for effect, e.g. print)."""

    e: Optional[Expr] = None


# --------------------------------------------------------------------------
# Stream computations
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Comp:
    loc: Loc = field(default=(0, 0), compare=False)


@dataclass(frozen=True)
class CTake(Comp):
    pass


@dataclass(frozen=True)
class CTakes(Comp):
    n: Optional[Expr] = None


@dataclass(frozen=True)
class CEmit(Comp):
    e: Optional[Expr] = None


@dataclass(frozen=True)
class CEmits(Comp):
    """emits e — emit every element of array-valued e."""

    e: Optional[Expr] = None


@dataclass(frozen=True)
class CReturn(Comp):
    e: Optional[Expr] = None


@dataclass(frozen=True)
class CDo(Comp):
    """do { stmts } — imperative block as a unit-valued computer."""

    body: Tuple[Stmt, ...] = ()


@dataclass(frozen=True)
class CBind(Comp):
    """x <- c1 ; c2  (var=None for plain seq)."""

    var: Optional[str] = None
    var_ty: Optional[Ty] = None
    first: Optional[Comp] = None
    rest: Optional[Comp] = None


@dataclass(frozen=True)
class CVarDecl(Comp):
    """var x : t := e ; rest — stream-level mutable state."""

    name: str = ""
    ty: Optional[Ty] = None
    init: Optional[Expr] = None
    rest: Optional[Comp] = None


@dataclass(frozen=True)
class CLetDecl(Comp):
    """let x = e ; rest — stream-level immutable binding."""

    name: str = ""
    e: Optional[Expr] = None
    rest: Optional[Comp] = None


@dataclass(frozen=True)
class CLetComp(Comp):
    """let comp x = c ; rest — local computation binding."""

    name: str = ""
    c: Optional[Comp] = None
    rest: Optional[Comp] = None


@dataclass(frozen=True)
class CRepeat(Comp):
    body: Optional[Comp] = None


@dataclass(frozen=True)
class CMap(Comp):
    """map f — f names an expression function (user/ext/builtin)."""

    fname: str = ""


@dataclass(frozen=True)
class CPipe(Comp):
    """c1 >>> c2 (par=False) or c1 |>>>| c2 (par=True)."""

    up: Optional[Comp] = None
    down: Optional[Comp] = None
    par: bool = False


@dataclass(frozen=True)
class CIf(Comp):
    c: Optional[Expr] = None
    then: Optional[Comp] = None
    els: Optional[Comp] = None


@dataclass(frozen=True)
class CFor(Comp):
    """for i in [start, len] body — `len` iterations (computer)."""

    var: Optional[str] = None
    start: Optional[Expr] = None
    count: Optional[Expr] = None
    body: Optional[Comp] = None


@dataclass(frozen=True)
class CTimes(Comp):
    """times n body."""

    count: Optional[Expr] = None
    body: Optional[Comp] = None


@dataclass(frozen=True)
class CWhile(Comp):
    c: Optional[Expr] = None
    body: Optional[Comp] = None


@dataclass(frozen=True)
class CUntil(Comp):
    """do body until c — body runs at least once (reference `until`)."""

    c: Optional[Expr] = None
    body: Optional[Comp] = None


@dataclass(frozen=True)
class CCall(Comp):
    """name(args) — instantiate a comp function (inlined at elaboration,
    the reference inliner's role), or a zero-arg reference to a bound
    comp name."""

    name: str = ""
    args: Tuple[Expr, ...] = ()


@dataclass(frozen=True)
class CRead(Comp):
    """read[t] — stream source (driver-provided input)."""

    ty: Optional[Ty] = None


@dataclass(frozen=True)
class CWrite(Comp):
    """write[t] — stream sink (driver-consumed output)."""

    ty: Optional[Ty] = None


# --------------------------------------------------------------------------
# Top-level declarations
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Param:
    name: str
    ty: Optional[Ty]
    loc: Loc = field(default=(0, 0), compare=False)


@dataclass(frozen=True)
class Decl:
    loc: Loc = field(default=(0, 0), compare=False)


@dataclass(frozen=True)
class DFun(Decl):
    """fun f(params) [: t] { stmts } — expression function."""

    name: str = ""
    params: Tuple[Param, ...] = ()
    ret_ty: Optional[Ty] = None
    body: Tuple[Stmt, ...] = ()


@dataclass(frozen=True)
class DFunComp(Decl):
    """fun comp f(params) { comp } — computation function."""

    name: str = ""
    params: Tuple[Param, ...] = ()
    body: Optional[Comp] = None


@dataclass(frozen=True)
class DLet(Decl):
    """let x = e — top-level constant."""

    name: str = ""
    e: Optional[Expr] = None


@dataclass(frozen=True)
class DLetComp(Decl):
    """let comp x = c — top-level computation (main is one of these)."""

    name: str = ""
    c: Optional[Comp] = None


@dataclass(frozen=True)
class DExt(Decl):
    """ext fun f(params) : t — binding to the externals registry
    (the reference's SORA `ext` declarations, SURVEY.md §2.3)."""

    name: str = ""
    params: Tuple[Param, ...] = ()
    ret_ty: Optional[Ty] = None


@dataclass(frozen=True)
class DStruct(Decl):
    """struct Name = { f1: t1; f2: t2 }"""

    name: str = ""
    fields: Tuple[Tuple[str, Ty], ...] = ()


@dataclass(frozen=True)
class Program:
    decls: Tuple[Decl, ...] = ()


# --------------------------------------------------------------------------
# Canonical traversal helpers
#
# Every analysis that walks the surface AST (purity/bit-width inference
# in lutinfer, read/write sets for staged loops in eval, weight/effect
# scans in backend/hybrid) iterates children through THESE generators,
# so the node inventory lives in exactly one place. They raise on an
# unknown node class — a future statement/expression kind breaks the
# walkers loudly instead of being silently skipped (which would, e.g.,
# let an effectful block be jit-wrapped or drop a written cell from a
# staged-loop carry).
# --------------------------------------------------------------------------

_LEAF_EXPRS = (EInt, EFloat, EBit, EBool, EString, EVar)


def child_exprs(e: Optional[Expr]):
    """Direct sub-expressions of `e` (none for leaves/None)."""
    if e is None or isinstance(e, _LEAF_EXPRS):
        return
    if isinstance(e, EUn):
        kids = (e.e,)
    elif isinstance(e, EBin):
        kids = (e.a, e.b)
    elif isinstance(e, ECond):
        kids = (e.c, e.a, e.b)
    elif isinstance(e, ECall):
        kids = e.args
    elif isinstance(e, EIdx):
        kids = (e.arr, e.i)
    elif isinstance(e, ESlice):
        kids = (e.arr, e.i, e.n)
    elif isinstance(e, EField):
        kids = (e.e,)
    elif isinstance(e, EArrLit):
        kids = e.elems
    elif isinstance(e, EStructLit):
        kids = tuple(v for _, v in e.fields)
    else:
        raise TypeError(f"child_exprs: unknown expression node "
                        f"{type(e).__name__}")
    for k in kids:
        if k is not None:
            yield k


def iter_exprs(e: Optional[Expr]):
    """`e` and every expression beneath it, depth-first."""
    if e is None:
        return
    yield e
    for k in child_exprs(e):
        yield from iter_exprs(k)


def _ty_dim_exprs(ty: Optional[Ty]):
    """Array-dimension expressions inside a type annotation — they are
    READS (a sliced environment must ship `n` for `arr[n] double`)."""
    while isinstance(ty, TArr):
        if ty.n is not None:
            yield ty.n
        ty = ty.elem


def stmt_exprs(st: Stmt):
    """Expressions appearing directly in `st` (not in nested stmts),
    including array dimensions in declared types."""
    if isinstance(st, SVar):
        kids = (st.init,) + tuple(_ty_dim_exprs(st.ty))
    elif isinstance(st, SLet):
        kids = (st.e,) + tuple(_ty_dim_exprs(st.ty))
    elif isinstance(st, SAssign):
        kids = (st.lval, st.e)
    elif isinstance(st, SIf):
        kids = (st.c,)
    elif isinstance(st, SFor):
        kids = (st.start, st.count)
    elif isinstance(st, SWhile):
        kids = (st.c,)
    elif isinstance(st, (SReturn, SExpr)):
        kids = (st.e,)
    else:
        raise TypeError(f"stmt_exprs: unknown statement node "
                        f"{type(st).__name__}")
    for k in kids:
        if k is not None:
            yield k


def child_stmt_blocks(st: Stmt):
    """Nested statement tuples of `st`."""
    if isinstance(st, SIf):
        yield st.then
        yield st.els
    elif isinstance(st, (SFor, SWhile)):
        yield st.body


def iter_stmts(stmts):
    """Every statement in the body, depth-first (including nested)."""
    for st in stmts:
        yield st
        for blk in child_stmt_blocks(st):
            yield from iter_stmts(blk)


def iter_stmt_exprs(stmts):
    """Every expression anywhere in the body, depth-first."""
    for st in iter_stmts(stmts):
        for e in stmt_exprs(st):
            yield from iter_exprs(e)
