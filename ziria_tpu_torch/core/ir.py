"""IR for the two-level stream-computation language (counterpart of
ziria_tpu/core/ir.py; the node set is the same).

The reference language (SURVEY.md §0) has an *expression* level (first-order
imperative code over scalars/arrays) and a *stream computation* level whose
terms are either **computers** — consume/produce stream items and terminate
with a control value — or **transformers** — run forever. This module is the
stream level. The expression level is ordinary Python functions over
numpy arrays and torch tensors, closed over an environment of bound
control values (`Bind`) and mutable refs (`LetRef`).

Design notes (TPU-first, deliberately NOT a port of the reference's
Haskell AST):

- Components carry *explicit* state (``map_accum``) instead of ambient
  mutable globals, so every static-rate pipeline segment lowers to a pure
  ``(state, in_chunk) -> (state, out_chunk)`` function — the shape the
  jit backend's stage loop and ``torch.func.vmap`` want.
- Cardinality analysis (core/card.py) computes synchronous-dataflow rates.
  Where the reference *rewrites* the AST to vectorize (its `Vectorize.hs`
  pass), we *plan*: rates become reshape/vmap axes at lowering time
  (backend/lower.py), and the chosen batching width is a planner knob, not
  a program transformation.
- Expressions take the environment as an argument (`lambda env: ...`) so
  the IR stays first-order and analyzable; no higher-order continuation
  tricks that would block cardinality analysis.

Combinator surface (reference counterparts in parens):

    take / takes(n)            (take / takes n)
    emit1(e) / emits(e, n)     (emit / emits)
    ret(e)                     (return e)
    seq(c1, c2, ...)           (c1 ; c2 ; ...)
    let(name, c1, c2)          (name <- c1 ; c2)
    zmap(f)                    (map f)
    map_accum(f, init)         (stateful map: var st; repeat { x<-take; ... })
    repeat(c)                  (repeat c)
    a >> b  == pipe(a, b)      (a >>> b)
    par_pipe(a, b)             (a |>>>| b) — placement hint: stage boundary
    for_loop(n, body)          (times / for)
    while_loop(cond, body)     (while)
    branch(cond, t, f)         (if/then/else)
    jax_block(fn, ...)         escape hatch: chunk-level torch function
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# Environments: bindings from `let` plus mutable refs from `let_ref`.
# --------------------------------------------------------------------------


class Env:
    """Lexically scoped environment. `bind` makes immutable bindings (from
    monadic `let`); `bind_ref` makes mutable cells (from `let_ref`). Only
    refs are assignable — `Assign` to a let-binding is an error, so a
    typo'd assignment can never silently corrupt a bound value."""

    __slots__ = ("_vars", "_refs", "_parent")

    def __init__(self, parent: Optional["Env"] = None):
        self._vars = {}
        self._refs = {}
        self._parent = parent

    def child(self) -> "Env":
        return Env(self)

    def bind(self, name: str, value: Any) -> None:
        self._vars[name] = value

    def bind_ref(self, name: str, value: Any) -> None:
        self._refs[name] = value

    def lookup(self, name: str) -> Any:
        e = self
        while e is not None:
            if name in e._vars:
                return e._vars[name]
            if name in e._refs:
                return e._refs[name]
            e = e._parent
        raise KeyError(f"unbound variable {name!r}")

    def __getitem__(self, name: str) -> Any:
        return self.lookup(name)

    def set(self, name: str, value: Any) -> None:
        """Assign to an existing ref (let_ref) binding, innermost first."""
        e = self
        while e is not None:
            if name in e._refs:
                e._refs[name] = value
                return
            if name in e._vars:
                raise KeyError(
                    f"assignment to immutable let-binding {name!r} "
                    f"(use let_ref for mutable state)")
            e = e._parent
        raise KeyError(f"assignment to unbound variable {name!r}")


# Expression: a Python callable from Env to a value. Plain (non-callable)
# values are accepted anywhere an expression is and treated as constants.
Expr = Any


def eval_expr(expr: Expr, env: Env) -> Any:
    return expr(env) if callable(expr) else expr


# --------------------------------------------------------------------------
# IR nodes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Comp:
    """Base class for stream computations."""

    def __rshift__(self, other: "Comp") -> "Comp":
        return Pipe(self, other)

    def label(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class Take(Comp):
    """Computer: consume one item; terminates with that item as value."""


@dataclass(frozen=True)
class Takes(Comp):
    """Computer: consume `n` items; value is the length-n array of them."""

    n: int


@dataclass(frozen=True)
class Emit(Comp):
    """Computer: emit one item (the value of `expr`); value is None."""

    expr: Expr


@dataclass(frozen=True)
class Emits(Comp):
    """Computer: emit the `n` elements of array-valued `expr`; value None.

    `n` must be static — it feeds cardinality analysis the same way the
    reference's cardinality pass needs static take/emit multiplicities.
    """

    expr: Expr
    n: int


@dataclass(frozen=True)
class Return(Comp):
    """Computer: no stream I/O; terminates immediately with `expr`'s value."""

    expr: Expr


@dataclass(frozen=True)
class Bind(Comp):
    """Computer: run `first`, bind its value to `var`, then run `rest`."""

    first: Comp
    var: Optional[str]
    rest: Comp


@dataclass(frozen=True)
class LetRef(Comp):
    """Computer: introduce a mutable ref `var` (initial `init`) around `body`.

    Counterpart of the reference's local `var` declarations. The jit backend
    only supports refs that are threaded through `map_accum` state; LetRef
    is interpreter-general.
    """

    var: str
    init: Expr
    body: Comp


@dataclass(frozen=True)
class Assign(Comp):
    """Computer: env[var] := expr; value None."""

    var: str
    expr: Expr


@dataclass(frozen=True)
class Map(Comp):
    """Transformer: apply `f` to each input chunk of `in_arity` items,
    producing a chunk of `out_arity` items.

    in_arity == 1 means scalar items (f: item -> item); in_arity > 1 means
    f takes an array of shape (in_arity, ...) — this is how already-
    vectorized blocks (e.g. a 64-point FFT) appear, and the unit the
    backend's planner multiplies into batch axes.

    `in_domain`, if set, declares that input items are integers in
    [0, in_domain) — the analogue of the reference's small-bit-width
    types that drive AutoLUT (core/autolut.py turns such maps into
    table gathers).

    `in_dtype`/`out_dtype`, if set (numpy dtype names, e.g. "uint8",
    "complex64"), declare the item dtypes this stage consumes/produces;
    the stream typechecker (core/types.py) propagates them across `>>>`
    and rejects mismatched compositions — the item-type half of the
    reference's TcUnify that round 1 left opaque (VERDICT r1 weak #6).

    `lut`, if set, is an inferred-LUT adapter (frontend/lutinfer.MapLut,
    the reference's LUTAnalysis role): it generalizes `in_domain` to
    packed multi-bit items (e.g. `arr[8] bit`), providing `.domain`,
    `.build_table()` and `.encode(item) -> index` for core/autolut.py.
    """

    f: Callable[..., Any]
    in_arity: int = 1
    out_arity: int = 1
    name: Optional[str] = None
    in_domain: Optional[int] = None
    in_dtype: Optional[str] = None
    out_dtype: Optional[str] = None
    lut: Optional[Any] = field(default=None, compare=False)

    def label(self) -> str:
        return self.name or getattr(self.f, "__name__", "Map")


@dataclass(frozen=True)
class MapAccum(Comp):
    """Stateful transformer: f(state, chunk) -> (state, out_chunk).

    The workhorse for DSP blocks with carried state (scramblers, FIR delay
    lines, phase trackers). The jit backend runs its firings in order.
    `init` produces the initial state (callable taking no args, or value).

    `advance`, if set, is ``advance(state, n) -> state`` — the state
    after `n` firings with ANY inputs, for stages whose state evolves
    independently of the data (LFSR scramblers: M^n·s over GF(2); CFO
    phase accumulators: ph + n·eps). It lets stream/sequence
    parallelism (parallel/streampar.py) fast-forward each device's
    entry state instead of refusing the stage as sequential.

    `memory`, if set, declares FINITE input memory: the state after
    processing any >= `memory` input items is independent of what came
    before them (FIR delay lines: memory = taps-1; sliding windows:
    the window length). Stream parallelism then seeds each device's
    entry state with a short warmup scan over the `memory` items
    preceding its shard — exact, no approximation.
    """

    f: Callable[..., Any]
    init: Any
    in_arity: int = 1
    out_arity: int = 1
    name: Optional[str] = None
    in_dtype: Optional[str] = None
    out_dtype: Optional[str] = None
    advance: Optional[Callable[[Any, int], Any]] = field(
        default=None, compare=False)
    memory: Optional[int] = field(default=None, compare=False)

    def label(self) -> str:
        return self.name or getattr(self.f, "__name__", "MapAccum")

    def init_state(self):
        return self.init() if callable(self.init) else self.init


@dataclass(frozen=True)
class Repeat(Comp):
    """Transformer: run computer `body` over and over forever."""

    body: Comp


@dataclass(frozen=True)
class Pipe(Comp):
    """`up >>> down`: up's output stream feeds down's input stream.

    Terminates (with the terminator's value) as soon as either side does.
    """

    up: Comp
    down: Comp


@dataclass(frozen=True)
class ParPipe(Comp):
    """`up |>>>| down`: semantically identical to Pipe, but a *placement*
    directive — the reference spawns a thread per side with an SPSC queue
    between (SURVEY.md §3.3); our backend treats it as a stage boundary for
    sharding across devices (ppermute over ICI) instead of fusing.
    """

    up: Comp
    down: Comp


@dataclass(frozen=True)
class For(Comp):
    """Computer: run `body` `count` times; loop index bound to `var`.

    `count` may be an Expr (dynamic in the interpreter); static ints keep
    the node jit-lowerable.
    """

    var: Optional[str]
    count: Expr
    body: Comp


@dataclass(frozen=True)
class While(Comp):
    """Computer: run `body` while `cond` holds. Dynamic — interpreter (and
    frame-level jit patterns via masking), never inside fused static
    segments."""

    cond: Expr
    body: Comp


@dataclass(frozen=True)
class Branch(Comp):
    """Computer/transformer: if cond then a else b."""

    cond: Expr
    then: Comp
    els: Comp


@dataclass(frozen=True)
class JaxBlock(Comp):
    """Escape hatch transformer: an arbitrary chunk-level torch function
    (the reference's takes a jax function; the name is kept).

    f(state, chunk[(in_arity,...)]) -> (state, out_chunk[(out_arity,...)]).
    Used for blocks whose inner structure isn't worth expressing in the IR
    (e.g. a whole hand-written kernel). Equivalent role to the
    reference's `ext` C functions bound from SORA (SURVEY.md §2.2).
    """

    f: Callable[..., Any]
    init: Any
    in_arity: int
    out_arity: int
    name: Optional[str] = None

    def label(self) -> str:
        return self.name or getattr(self.f, "__name__", "JaxBlock")

    def init_state(self):
        return self.init() if callable(self.init) else self.init


# --------------------------------------------------------------------------
# Smart constructors / user surface
# --------------------------------------------------------------------------

take = Take()


def takes(n: int) -> Comp:
    if n <= 0:
        raise ValueError("takes(n) needs n >= 1")
    return Takes(n)


def emit1(expr: Expr) -> Comp:
    return Emit(expr)


# `emit` kept as an alias for the single-item form, matching reference syntax.
emit = emit1


def emits(expr: Expr, n: int) -> Comp:
    return Emits(expr, n)


def ret(expr: Expr) -> Comp:
    return Return(expr)


def seq(*comps: Comp) -> Comp:
    """c1 ; c2 ; ... — sequencing discarding intermediate values."""
    if not comps:
        raise ValueError("seq needs at least one computation")
    out = comps[-1]
    for c in reversed(comps[:-1]):
        out = Bind(c, None, out)
    return out


def let(var: str, first: Comp, rest: Comp) -> Comp:
    """var <- first ; rest"""
    return Bind(first, var, rest)


def let_ref(var: str, init: Expr, body: Comp) -> Comp:
    return LetRef(var, init, body)


def assign(var: str, expr: Expr) -> Comp:
    return Assign(var, expr)


def zmap(f: Callable, in_arity: int = 1, out_arity: int = 1,
         name: Optional[str] = None, in_domain: Optional[int] = None,
         in_dtype: Optional[str] = None,
         out_dtype: Optional[str] = None) -> Comp:
    return Map(f, in_arity, out_arity, name, in_domain, in_dtype,
               out_dtype)


def map_accum(f: Callable, init: Any, in_arity: int = 1, out_arity: int = 1,
              name: Optional[str] = None, in_dtype: Optional[str] = None,
              out_dtype: Optional[str] = None,
              advance: Optional[Callable] = None,
              memory: Optional[int] = None) -> Comp:
    if memory is not None and (int(memory) != memory or int(memory) < 1):
        # validate at construction so every consumer (fold's rescale,
        # widening, stream_parallel's warmup budget) sees a sane value
        raise ValueError(f"map_accum {name or f!r}: memory={memory!r} "
                         f"must be a positive integer (items of input "
                         f"history)")
    return MapAccum(f, init, in_arity, out_arity, name, in_dtype,
                    out_dtype, advance, memory)


def repeat(body: Comp) -> Comp:
    return Repeat(body)


def pipe(*comps: Comp) -> Comp:
    if not comps:
        raise ValueError("pipe needs at least one computation")
    out = comps[0]
    for c in comps[1:]:
        out = Pipe(out, c)
    return out


def par_pipe(*comps: Comp) -> Comp:
    if not comps:
        raise ValueError("par_pipe needs at least one computation")
    out = comps[0]
    for c in comps[1:]:
        out = ParPipe(out, c)
    return out


def for_loop(count: Expr, body: Comp, var: Optional[str] = None) -> Comp:
    return For(var, count, body)


def while_loop(cond: Expr, body: Comp) -> Comp:
    return While(cond, body)


def branch(cond: Expr, then: Comp, els: Comp) -> Comp:
    return Branch(cond, then, els)


def jax_block(f: Callable, init: Any = None, in_arity: int = 1,
              out_arity: int = 1, name: Optional[str] = None) -> Comp:
    return JaxBlock(f, init, in_arity, out_arity, name)


# --------------------------------------------------------------------------
# Structural helpers
# --------------------------------------------------------------------------


def map_children(c: Comp, f: Callable[[Comp, bool], Comp]) -> Comp:
    """Rebuild `c` with `f` applied to each direct child computation.

    `f(child, binds)` — `binds` is True when the construct introduces a
    binding visible inside that child (Bind's rest under a named var,
    LetRef's body, For's body under a loop var). Returns `c` itself when
    no child changed, so rewrite passes can detect fixpoints by
    identity. The single structural walker shared by the fold pass and
    AutoLUT — add new container nodes HERE, once.
    """
    if isinstance(c, Bind):
        a = f(c.first, False)
        b = f(c.rest, c.var is not None)
        return c if a is c.first and b is c.rest else Bind(a, c.var, b)
    if isinstance(c, LetRef):
        b = f(c.body, True)
        return c if b is c.body else LetRef(c.var, c.init, b)
    if isinstance(c, Repeat):
        b = f(c.body, False)
        return c if b is c.body else Repeat(b)
    if isinstance(c, Pipe):
        a, b = f(c.up, False), f(c.down, False)
        return c if a is c.up and b is c.down else Pipe(a, b)
    if isinstance(c, ParPipe):
        a, b = f(c.up, False), f(c.down, False)
        return c if a is c.up and b is c.down else ParPipe(a, b)
    if isinstance(c, For):
        b = f(c.body, c.var is not None)
        return c if b is c.body else For(c.var, c.count, b)
    if isinstance(c, While):
        b = f(c.body, False)
        return c if b is c.body else While(c.cond, b)
    if isinstance(c, Branch):
        a, b = f(c.then, False), f(c.els, False)
        return c if a is c.then and b is c.els else Branch(c.cond, a, b)
    return c


def pipeline_stages(comp: Comp) -> Sequence[Comp]:
    """Flatten nested Pipe into a left-to-right stage list (Pipe only —
    ParPipe boundaries are preserved as units; see parallel/stages.py)."""
    if isinstance(comp, Pipe):
        return list(pipeline_stages(comp.up)) + list(pipeline_stages(comp.down))
    return [comp]


def par_segments(comp: Comp) -> Sequence[Comp]:
    """Split at ParPipe boundaries into the reference's thread-stage units."""
    if isinstance(comp, ParPipe):
        return list(par_segments(comp.up)) + list(par_segments(comp.down))
    return [comp]
