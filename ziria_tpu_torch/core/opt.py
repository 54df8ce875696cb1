"""Fold/fusion optimizer: rewrite rules iterated to fixpoint (port copy of
ziria_tpu/core/opt.py, which imports no JAX).

Counterpart of the reference's `PassFold.hs` (SURVEY.md §2.1) — its
rewrite engine inlines, fuses `map f >>> map g`, simplifies
return/bind, and re-runs to fixpoint. TPU-first difference: XLA already
fuses elementwise chains *inside* one traced graph, so the payoff here
is **structural**, earlier in the pipeline: fewer IR stages means fewer
scan/vmap wrappers at lowering time, and rewriting `repeat(take;emit)`
into `Map` unlocks the parallel (vmap) lowering path where the generic
repeat body would otherwise be traced per-firing.

Rules (each preserves streaming semantics exactly — the test suite's
flag matrix asserts optimized == unoptimized output on both backends):

  R1  bind-assoc       Bind(Bind(a,x,b), y, c) -> Bind(a, x, Bind(b,y,c))
  R2  return-left      Bind(Return(e), None, rest) -> rest
  R3  repeat-take-emit repeat(x <- take(s) ; emit(s)(f x)) -> Map f
  R4  map-map fusion   Map f >>> Map g -> Map (g . f)   [rates matching]
  R5  map-accum fusion Map f >>> MapAccum g -> MapAccum (g . f)
                       MapAccum g >>> Map f -> MapAccum (f . g)
  R6  const-branch     Branch(const, t, e) -> t | e
  R7  pipe-assoc       canonical right-nesting of Pipe (stable fusion
                       scan order; ParPipe boundaries never crossed)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.ir import Env, eval_expr


# --------------------------------------------------------------------------
# Individual rules: each returns a rewritten node or None (no match)
# --------------------------------------------------------------------------


def _bind_assoc(c: ir.Comp) -> Optional[ir.Comp]:
    if (isinstance(c, ir.Bind) and isinstance(c.first, ir.Bind)
            and c.first.var is None):
        # seq-only association: when the inner bind names a variable,
        # re-association would widen its scope over `c.rest` and could
        # shadow an identically-named outer binding (closures are
        # opaque, so usage can't be checked) — those stay as-is
        inner = c.first
        return ir.Bind(inner.first, None,
                       ir.Bind(inner.rest, c.var, c.rest))
    return None


def _return_left(c: ir.Comp) -> Optional[ir.Comp]:
    if (isinstance(c, ir.Bind) and isinstance(c.first, ir.Return)
            and c.var is None and not callable(c.first.expr)):
        # only constant returns are dropped: a callable expr could read
        # refs set by earlier Assigns — dropping it is safe too (Return
        # has no effects), but keep the conservative constant-only form
        return c.rest
    return None


def _repeat_take_emit(c: ir.Comp) -> Optional[ir.Comp]:
    """repeat { x <- take/takes n ; emit/emits m (f x) }  ->  Map(f, n, m).

    The emit expression is a closure over the body's Env; the fused Map
    evaluates it in a fresh one-binding Env, which is exactly the body's
    environment shape (take binds one var, nothing else is in scope).
    """
    if not isinstance(c, ir.Repeat):
        return None
    b = c.body
    if not (isinstance(b, ir.Bind) and b.var is not None):
        return None
    if isinstance(b.first, ir.Take):
        n = 1
    elif isinstance(b.first, ir.Takes):
        n = b.first.n
    else:
        return None
    if isinstance(b.rest, ir.Emit):
        m, expr = 1, b.rest.expr
    elif isinstance(b.rest, ir.Emits):
        m, expr = b.rest.n, b.rest.expr
    else:
        return None
    var = b.var

    def fused(x, _expr=expr, _var=var):
        env = Env()
        env.bind(_var, x)
        return eval_expr(_expr, env)

    return ir.Map(fused, in_arity=n, out_arity=m,
                  name=f"fold[take{n}->emit{m}]")


def _compose_maps(f: Callable, g: Callable) -> Callable:
    def h(x):
        return g(f(x))
    return h


def _map_fusions(c: ir.Comp) -> Optional[ir.Comp]:
    if not isinstance(c, ir.Pipe):
        return None
    up, down = c.up, c.down
    if (isinstance(up, ir.Map) and isinstance(down, ir.Map)
            and up.out_arity == down.in_arity):
        # the fused map's input domain IS the upstream's declared domain,
        # so AutoLUT still applies after fusion
        return ir.Map(_compose_maps(up.f, down.f), up.in_arity,
                      down.out_arity,
                      name=f"{down.label()}.{up.label()}",
                      in_domain=up.in_domain,
                      in_dtype=up.in_dtype, out_dtype=down.out_dtype)
    if (isinstance(up, ir.Map) and isinstance(down, ir.MapAccum)
            and up.out_arity == down.in_arity):
        def fa(s, x, _f=up.f, _g=down.f):
            return _g(s, _f(x))
        # the fused stage carries the SAME state with the same
        # evolution, so the fast-forward stays valid; finite memory
        # rescales from accum-input items to map-input items
        # (ceil(mem / b) firings x a items each)
        mem = down.memory
        if mem is not None and down.in_arity:
            mem = -(-int(mem) // down.in_arity) * up.in_arity
        return ir.MapAccum(fa, down.init, up.in_arity, down.out_arity,
                           name=f"{down.label()}.{up.label()}",
                           in_dtype=up.in_dtype,
                           out_dtype=down.out_dtype,
                           advance=down.advance, memory=mem)
    if (isinstance(up, ir.MapAccum) and isinstance(down, ir.Map)
            and up.out_arity == down.in_arity):
        def fb(s, x, _f=up.f, _g=down.f):
            s2, y = _f(s, x)
            return s2, _g(y)
        return ir.MapAccum(fb, up.init, up.in_arity, down.out_arity,
                           name=f"{down.label()}.{up.label()}",
                           in_dtype=up.in_dtype,
                           out_dtype=down.out_dtype,
                           advance=up.advance, memory=up.memory)
    return None


def _const_branch(c: ir.Comp) -> Optional[ir.Comp]:
    if isinstance(c, ir.Branch) and not callable(c.cond):
        return c.then if c.cond else c.els
    return None


def _pipe_assoc(c: ir.Comp) -> Optional[ir.Comp]:
    if isinstance(c, ir.Pipe) and isinstance(c.up, ir.Pipe):
        return ir.Pipe(c.up.up, ir.Pipe(c.up.down, c.down))
    return None


# R3 is only sound where the emit closure cannot see outer bindings:
# under an enclosing LetRef / binder, `emit(f x)` may read those names,
# and the fused Map's fresh one-binding Env would lose them. The walker
# tracks scope and drops R3 inside any enclosing binder (conservative —
# closures are opaque, so "does it read y?" is unanswerable statically).
_RULES: Tuple[Callable, ...] = (
    _bind_assoc, _return_left, _map_fusions, _const_branch, _pipe_assoc,
)
_RULES_UNSCOPED: Tuple[Callable, ...] = _RULES + (_repeat_take_emit,)


# --------------------------------------------------------------------------
# Fixpoint driver
# --------------------------------------------------------------------------


def _rewrite_node(c: ir.Comp, rules) -> Tuple[ir.Comp, int]:
    n = 0
    changed = True
    while changed:
        changed = False
        for rule in rules:
            r = rule(c)
            if r is not None:
                c, n, changed = r, n + 1, True
    return c, n


def _rebuild(c: ir.Comp, f: Callable[[ir.Comp, bool], ir.Comp],
             scoped: bool) -> ir.Comp:
    """Apply f to each child via the shared walker (ir.map_children),
    threading `scoped` — True once any enclosing construct introduced a
    binding visible to descendants."""
    return ir.map_children(c, lambda ch, binds: f(ch, scoped or binds))


@dataclass
class FoldStats:
    rewrites: int
    passes: int


def fold(comp: ir.Comp, max_passes: int = 20) -> ir.Comp:
    """Optimize `comp` to fixpoint. Semantics-preserving by construction;
    the flag-matrix tests assert it."""
    out, _ = fold_with_stats(comp, max_passes)
    return out


def fold_with_stats(comp: ir.Comp,
                    max_passes: int = 20) -> Tuple[ir.Comp, FoldStats]:
    total = 0
    passes = 0
    for _ in range(max_passes):
        passes += 1
        count = [0]

        def walk(c: ir.Comp, scoped: bool = False) -> ir.Comp:
            c = _rebuild(c, walk, scoped)
            c, k = _rewrite_node(
                c, _RULES if scoped else _RULES_UNSCOPED)
            count[0] += k
            return c

        comp = walk(comp)
        total += count[0]
        if count[0] == 0:
            break
    return comp, FoldStats(rewrites=total, passes=passes)
