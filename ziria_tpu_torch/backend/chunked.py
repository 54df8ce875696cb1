"""Chunked state machines: stream-control loops on the card
(counterpart of ziria_tpu/backend/chunked.py).

The hybrid executor (backend/hybrid.py) runs heavy do-blocks on the
device but leaves the loops that walk the stream item by item (packet
detection, the OFDM symbol gather, chunked bit emission) to the
interpreter. This module turns such a loop (an `ir.For` / `ir.While`
whose body takes or emits) into ONE **chunked masked state machine**,
with the reference's semantics:

- the host bulk-pulls a window of up to `CHUNK_CAP` items;
- a step runs the loop body for as many iterations as fit wholly inside
  the window (guard: cursor + worst-case take <= available); takes are
  gathers at a carried cursor, emits are masked writes into an output
  buffer, the refs the body writes are carries at their entry dtypes;
- the step reports (iterations done, items consumed, items emitted,
  the written refs) in one host read; the host flushes the emissions,
  pushes the unconsumed items back to the shared `interp.Source` and
  refills the window;
- at EOF the remaining iterations (at most a bound-sized sliver) run on
  the item-level interpreter, with its exact EOF semantics.

The design for the card. The reference steps one frame with a
`lax.while_loop` and batches frames with `jax.vmap`; `torch.func.vmap`
cannot batch a data-dependent loop, so the step here is **lane-batched
from the start**: every operand carries a leading lane axis (one frame
is one lane), and the loop is a sequence of *masked iterations*: one
iteration of the body runs for every lane under `torch.func.vmap` (the
evaluator's "vmap" mode: a branch on a lane value becomes a select of
both arms, a take a gather at the lane's cursor, an emit a masked
write), and a lane whose guard fails keeps its state from then on.

- The **plain version** (any device; the CPU tests run it) is an eager
  loop of such iterations, `_iters_per_block` at a time, reading "is
  any lane still active" from the host once a block.
- On a CUDA device a block is **a CUDA graph** of those iterations,
  captured once per (machine, key, lane bucket, static values) and
  replayed until no lane is active: the window, the carries, the
  cursor and the output buffer live in the graph's own tensors, copied
  in before and out after. A For loop's replays are predicted from its
  trip count and the window, so a step usually makes one host read.

A loop is wrapped only when its body is provably stageable (no
Pipe/Repeat/Map inside, no print/error, every closure carrying its
source AST, static per-iteration take/emit bounds). The first execution
of a machine stages one iteration of its body before the loop runs (the
reference's discovery pass, which also learns the emitted item's dtype
and shape); a body the stager cannot express (a nested While, a loop
count or a branch value that differs per lane, a host read of a device
value) is demoted there to the interpreter, for good, and recorded in
`DEMOTED`. Nothing else is demoted: a step that fails raises.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Set

import numpy as np
import torch

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.frontend import ast as A
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.utils import dispatch
from ziria_tpu_torch.utils.dispatch import pad_lanes

# a For loop moving fewer items than this (takes+emits, whole loop)
# stays on the interpreter: a device step would cost more than it saves
MIN_ITEMS_FOR = 192
# While bodies lighter than this stay interpreted (only sample-walking
# loops earn a machine)
MIN_WHILE_WEIGHT = 16
# the reference stages nested For loops above this trip count as a
# lax.while_loop and unrolls the rest; a CUDA graph records the same
# kernels either way, so the port unrolls every nested loop whose count
# is a host value (the constant is kept for the plan's parity)
UNROLL_N = 16
# input window capacity (items); raised per node to cover one
# iteration's worst-case take
CHUNK_CAP = 4096
# emitting While loops: output-buffer budget (items) shared between the
# per-iteration emission bound and the per-step iteration cap
WHILE_OUT_ITEMS = 65536
# written values at or below this many elements come back to numpy at
# the end of a loop (the interpreter's per-item fast path)
HOST_SMALL_MAX = 4096


class _Unstageable(Exception):
    """Structural reason this subtree cannot be chunk-compiled."""


class _Unboundable(_Unstageable):
    pass


# ---------------------------------------------------------------------
# Device-step indirection: every chunk step goes through _step_call so a
# frame batcher (backend/framebatch.StepBatcher) can intercept it: under
# run_many each frame thread parks here and N lanes ride one lane-batched
# step.

_TLS = threading.local()

#: machine steps (device_calls), graph captures and replays, eager
#: iteration blocks and host reads since the last reset; a step is also
#: a "chunked.step" (or "framebatch.step") dispatch and a replay a
#: "chunked.replay" one (utils/dispatch.record)
STATS = {"device_calls": 0, "captures": 0, "replays": 0,
         "eager_blocks": 0, "host_reads": 0}

#: loops demoted to the interpreter at their first execution:
#: (loop label, reason)
DEMOTED: List[tuple] = []


def reset_counts() -> None:
    for k in STATS:
        STATS[k] = 0
    DEMOTED.clear()


def _step_call(node: "_ChunkLoop", key, args):
    b = getattr(_TLS, "batcher", None)
    if b is not None:
        return b.call(node, key, args)
    with dispatch.timed("chunked.step"):
        out = node._machines[key].run([args])[0]
    STATS["device_calls"] += 1
    return out


# ------------------------------------------------------------ analysis


def _children(c: ir.Comp):
    if isinstance(c, ir.Bind):
        return (c.first, c.rest)
    if isinstance(c, ir.LetRef):
        return (c.body,)
    if isinstance(c, (ir.For, ir.While, ir.Repeat)):
        return (c.body,)
    if isinstance(c, ir.Branch):
        return (c.then, c.els)
    if isinstance(c, (ir.Pipe, ir.ParPipe)):
        return (c.up, c.down)
    return ()


def _walk(c: ir.Comp):
    yield c
    for ch in _children(c):
        yield from _walk(ch)


def has_stream_io(c: ir.Comp) -> bool:
    return any(isinstance(x, (ir.Take, ir.Takes, ir.Emit, ir.Emits))
               for x in _walk(c))


def _closure_ast(e) -> Optional[A.Expr]:
    """Surface AST of a comp-level Expr, if the elaborator attached it."""
    return getattr(e, "z_expr", None) if callable(e) else None


def _expr_has_effects(e: A.Expr, ctx, seen: Set[str]) -> bool:
    from ziria_tpu_torch.backend.hybrid import _has_effects
    for x in A.iter_exprs(e):
        if isinstance(x, A.ECall):
            if x.name in ("print", "println", "error"):
                return True
            if ctx is not None and x.name in getattr(ctx, "funs", {}) \
                    and x.name not in seen:
                seen.add(x.name)
                if _has_effects(ctx.funs[x.name].decl.body, ctx, seen):
                    return True
    return False


def _node_exprs(c: ir.Comp) -> list:
    """The expression closures of one node."""
    if isinstance(c, (ir.Emit, ir.Emits, ir.Return, ir.Assign)):
        return [c.expr]
    if isinstance(c, ir.LetRef):
        return [c.init]
    if isinstance(c, ir.For):
        return [c.count]
    if isinstance(c, (ir.While, ir.Branch)):
        return [c.cond]
    return []


def check_stageable(comp: ir.Comp) -> None:
    """Raise _Unstageable unless every node/closure in `comp` is the
    kind the stager knows how to run (structure + effects only;
    runtime bounds are checked per execution)."""
    from ziria_tpu_torch.backend.hybrid import _has_effects
    seen: Set[str] = set()
    for c in _walk(comp):
        if isinstance(c, (ir.Repeat, ir.Pipe, ir.ParPipe, ir.Map,
                          ir.MapAccum, ir.JaxBlock)):
            raise _Unstageable(f"{type(c).__name__} inside loop")
        if isinstance(c, ir.Return) and callable(c.expr):
            stmts = getattr(c.expr, "z_stmts", None)
            if stmts is not None:
                if _has_effects(stmts, getattr(c.expr, "z_ctx", None),
                                seen):
                    raise _Unstageable("print/error in do-block")
                continue
        for e in _node_exprs(c):
            if not callable(e):
                continue  # plain constant
            ast = _closure_ast(e)
            if ast is None:
                raise _Unstageable("opaque expression closure")
            if _expr_has_effects(ast, getattr(e, "z_ctx", None), seen):
                raise _Unstageable("print/error in expression")


def comp_writes(comp: ir.Comp,
                shadow: frozenset = frozenset()) -> Set[str]:
    """Names of enclosing-scope refs this subtree may assign — the
    loop-carried set. Locally-declared (LetRef / bind / loop-var) names
    are shadowed out. Over-approximates through do-blocks via the
    statement-level write analysis (as the staged evaluator does)."""
    out: Set[str] = set()
    if isinstance(comp, ir.Assign):
        if comp.var not in shadow:
            out.add(comp.var)
    elif isinstance(comp, ir.Return) and callable(comp.expr):
        stmts = getattr(comp.expr, "z_stmts", None)
        if stmts is not None:
            w: Set[str] = set()
            E._stmt_writes(stmts, w)
            out |= w - shadow
    elif isinstance(comp, ir.Bind):
        out |= comp_writes(comp.first, shadow)
        sh = shadow | {comp.var} if comp.var is not None else shadow
        out |= comp_writes(comp.rest, sh)
    elif isinstance(comp, ir.LetRef):
        out |= comp_writes(comp.body, shadow | {comp.var})
    elif isinstance(comp, ir.For):
        sh = shadow | {comp.var} if comp.var is not None else shadow
        out |= comp_writes(comp.body, sh)
    elif isinstance(comp, (ir.While, ir.Repeat)):
        out |= comp_writes(comp.body, shadow)
    elif isinstance(comp, ir.Branch):
        out |= comp_writes(comp.then, shadow)
        out |= comp_writes(comp.els, shadow)
    elif isinstance(comp, (ir.Pipe, ir.ParPipe)):
        out |= comp_writes(comp.up, shadow)
        out |= comp_writes(comp.down, shadow)
    else:
        orig = getattr(comp, "orig", None)
        if orig is not None:
            out |= comp_writes(orig, shadow)
    return out


def _comp_reads(comp: ir.Comp, acc: Set[str]) -> None:
    """Every name the closures of `comp` mention (reads and writes), and
    the names of comp-level assignments: the env slice a step needs."""
    for c in _walk(getattr(comp, "orig", comp)):
        orig = getattr(c, "orig", None)
        if orig is not None:
            _comp_reads(orig, acc)
            continue
        if isinstance(c, ir.Assign):
            acc.add(c.var)
        for e in _node_exprs(c):
            stmts = getattr(e, "z_stmts", None)
            if stmts is not None:
                E._stmt_reads(stmts, acc)
                E._stmt_writes(stmts, acc)
            ast = _closure_ast(e)
            if ast is not None:
                E._expr_reads(ast, acc)


def _static_names(comp: ir.Comp) -> Set[str]:
    """Names a body uses where the evaluator needs a host value: the
    bounds of its statement for-loops and of its nested comp-level For
    loops, and everything those names are computed from inside the
    body. A step keeps them as host values, equal on every lane of a
    batch (framebatch groups lanes by them) and part of a graph's key."""
    need: Set[str] = set()
    defs: Dict[str, Set[str]] = {}

    def stmt_walk(stmts):
        for st in A.iter_stmts(stmts):
            if isinstance(st, A.SFor):
                E._expr_reads(st.start, need)
                E._expr_reads(st.count, need)
            if isinstance(st, (A.SVar, A.SLet)):
                e = st.init if isinstance(st, A.SVar) else st.e
                E._expr_reads(e, defs.setdefault(st.name, set()))
            elif isinstance(st, A.SAssign):
                r = st.lval
                while isinstance(r, (A.EIdx, A.ESlice, A.EField)):
                    r = r.e if isinstance(r, A.EField) else r.arr
                if isinstance(r, A.EVar):
                    E._expr_reads(st.e, defs.setdefault(r.name, set()))

    for c in _walk(getattr(comp, "orig", comp)):
        orig = getattr(c, "orig", None)
        if orig is not None:
            need |= _static_names(orig)
            continue
        if isinstance(c, ir.For):
            ast = _closure_ast(c.count)
            if ast is not None:
                E._expr_reads(ast, need)
        for e in _node_exprs(c):
            stmts = getattr(e, "z_stmts", None)
            if stmts is not None:
                stmt_walk(stmts)
    todo = list(need)
    while todo:
        for m in defs.get(todo.pop(), ()):
            if m not in need:
                need.add(m)
                todo.append(m)
    return need


def _count_bound(count, env: ir.Env, wset: Set[str]) -> int:
    """Evaluate a nested loop count against the ENTRY env. Only safe if
    the wrapped region never writes the count's free variables."""
    if not callable(count):
        return int(count)
    ast = _closure_ast(count)
    if ast is None:
        raise _Unboundable("opaque count")
    from ziria_tpu_torch.frontend.elab import free_vars
    if free_vars(ast) & wset:
        raise _Unboundable("count depends on loop-written state")
    return int(ir.eval_expr(count, env))


def take_bound(comp: ir.Comp, env: ir.Env, wset: Set[str]) -> int:
    """Max items one execution of `comp` can take (static per entry)."""
    if isinstance(comp, ir.Take):
        return 1
    if isinstance(comp, ir.Takes):
        return comp.n
    if isinstance(comp, ir.Bind):
        return (take_bound(comp.first, env, wset)
                + take_bound(comp.rest, env, wset))
    if isinstance(comp, ir.LetRef):
        return take_bound(comp.body, env, wset)
    if isinstance(comp, ir.Branch):
        return max(take_bound(comp.then, env, wset),
                   take_bound(comp.els, env, wset))
    if isinstance(comp, ir.For):
        b = take_bound(comp.body, env, wset)
        if b == 0:
            return 0
        return max(0, _count_bound(comp.count, env, wset)) * b
    if isinstance(comp, ir.While):
        if has_stream_io(comp.body):
            raise _Unboundable("stream I/O inside nested while")
        return 0
    orig = getattr(comp, "orig", None)
    if orig is not None:
        return take_bound(orig, env, wset)
    return 0


def emit_bound(comp: ir.Comp, env: ir.Env, wset: Set[str]) -> int:
    if isinstance(comp, ir.Emit):
        return 1
    if isinstance(comp, ir.Emits):
        return comp.n
    if isinstance(comp, ir.Bind):
        return (emit_bound(comp.first, env, wset)
                + emit_bound(comp.rest, env, wset))
    if isinstance(comp, ir.LetRef):
        return emit_bound(comp.body, env, wset)
    if isinstance(comp, ir.Branch):
        return max(emit_bound(comp.then, env, wset),
                   emit_bound(comp.els, env, wset))
    if isinstance(comp, ir.For):
        b = emit_bound(comp.body, env, wset)
        if b == 0:
            return 0
        return max(0, _count_bound(comp.count, env, wset)) * b
    if isinstance(comp, ir.While):
        if has_stream_io(comp.body):
            raise _Unboundable("stream I/O inside nested while")
        return 0
    orig = getattr(comp, "orig", None)
    if orig is not None:
        return emit_bound(orig, env, wset)
    return 0


def _body_weight(comp: ir.Comp) -> int:
    """Rough op weight of a loop body (for the wrap/no-wrap gate)."""
    from ziria_tpu_torch.backend.hybrid import _stmts_weight
    w = 0
    for c in _walk(comp):
        w += 1
        if isinstance(c, ir.Return) and callable(c.expr):
            stmts = getattr(c.expr, "z_stmts", None)
            if stmts is not None:
                w += _stmts_weight(stmts)
    return w


# ------------------------------------------------------------ stager
#
# `_stage` runs ONE execution of a body for one lane; the machine calls
# it under torch.func.vmap, so every value below is a lane's view and
# every lane-dependent decision is a select.


class _St:
    """Mutable staging state threaded through one iteration. `spy`, when
    set, records emitted item values instead of writing the output
    buffer (the discovery pass that learns the emission dtype/shape)."""

    __slots__ = ("chunk", "pos", "out_buf", "out_n", "spy")

    def __init__(self, chunk, pos, out_buf, out_n, spy=None):
        self.chunk = chunk
        self.pos = pos
        self.out_buf = out_buf
        self.out_n = out_n
        self.spy = spy


def _take(chunk, pos, n: Optional[int]):
    """chunk[pos] (n None) or chunk[pos:pos+n] at a lane's cursor, as a
    gather (a slice at a device start would read the host)."""
    cap = chunk.shape[0]
    if n is None:
        return torch.index_select(chunk, 0,
                                  pos.reshape(1).clamp(0, cap - 1))[0]
    idx = (pos + torch.arange(n, device=chunk.device)).clamp(0, cap - 1)
    return torch.index_select(chunk, 0, idx)


def _emit(st: _St, v, n: Optional[int]) -> None:
    """Write one item (n None) or n items at the lane's output count:
    a select over the buffer, so a lane writes only its own slots."""
    buf = st.out_buf
    slot = torch.arange(buf.shape[0], device=buf.device) - st.out_n
    v = E._t(v, buf.device)
    if v.is_complex() and not buf.is_complex():
        v = v.real
    v = v.to(buf.dtype)
    tail = (1,) * (buf.dim() - 1)
    if n is None:
        hit = (slot == 0).reshape((-1,) + tail)
        st.out_buf = torch.where(hit, v, buf)
        st.out_n = st.out_n + 1
        return
    hit = ((slot >= 0) & (slot < n)).reshape((-1,) + tail)
    rows = torch.index_select(v, 0, slot.clamp(0, n - 1))
    st.out_buf = torch.where(hit, rows, buf)
    st.out_n = st.out_n + n


def _select(c, t, f):
    """Per-lane select of two values of one cell (structs field-wise)."""
    if t is f:
        return t
    if isinstance(t, dict) or isinstance(f, dict):
        if not (isinstance(t, dict) and isinstance(f, dict)
                and set(t) == set(f)):
            raise _Unstageable("branch arms leave a struct in different "
                               "shapes")
        return {k: (t[k] if k == "__struct__" else _select(c, t[k], f[k]))
                for k in t}
    if t is None or f is None:
        raise _Unstageable("branch arm leaves a cell unset")
    ta, fa = E._ts([t, f], c.device)
    return torch.where(c, ta, fa)


def _stage(comp: ir.Comp, env: ir.Env, st: _St):
    """Run one execution of `comp` for one lane. Returns its value."""
    orig = getattr(comp, "orig", None)
    if orig is not None:               # nested _ChunkLoop: stage inline
        return _stage(orig, env, st)

    if isinstance(comp, ir.Take):
        x = _take(st.chunk, st.pos, None)
        st.pos = st.pos + 1
        return x

    if isinstance(comp, ir.Takes):
        xs = _take(st.chunk, st.pos, comp.n)
        st.pos = st.pos + comp.n
        return xs

    if isinstance(comp, (ir.Emit, ir.Emits)):
        v = ir.eval_expr(comp.expr, env)
        many = isinstance(comp, ir.Emits)
        if st.spy is not None:
            v = E._t(v, st.chunk.device)
            st.spy.append(v[0] if many else v)
            return None
        _emit(st, v, comp.n if many else None)
        return None

    if isinstance(comp, ir.Return):
        return ir.eval_expr(comp.expr, env)

    if isinstance(comp, ir.Bind):
        v = _stage(comp.first, env, st)
        if comp.var is not None:
            env = env.child()
            env.bind(comp.var, v)
        return _stage(comp.rest, env, st)

    if isinstance(comp, ir.LetRef):
        env = env.child()
        env.bind_ref(comp.var, ir.eval_expr(comp.init, env))
        return _stage(comp.body, env, st)

    if isinstance(comp, ir.Assign):
        env.set(comp.var, ir.eval_expr(comp.expr, env))
        return None

    if isinstance(comp, ir.Branch):
        pred = ir.eval_expr(comp.cond, env)
        if not isinstance(pred, torch.Tensor):
            return _stage(comp.then if bool(pred) else comp.els, env, st)
        return _staged_branch(comp, pred, env, st)

    if isinstance(comp, ir.For):
        n = ir.eval_expr(comp.count, env)
        if isinstance(n, torch.Tensor):
            raise _Unstageable("nested loop count differs per lane")
        v = None
        for i in range(int(n)):
            e = env
            if comp.var is not None:
                e = env.child()
                e.bind(comp.var, i)
            v = _stage(comp.body, e, st)
        return v

    if isinstance(comp, ir.While):
        raise _Unstageable("nested while loop in a chunk body")

    raise _Unstageable(f"cannot stage {type(comp).__name__}")


def _resolves_ref(env: ir.Env, name: str) -> bool:
    e = env
    while e is not None:
        if name in e._refs:
            return True
        if name in e._vars:
            return False
        e = e._parent
    return False


def _carry_refs(comp: ir.Comp, env: ir.Env) -> List[str]:
    """Written ref names that resolve in `env` (outer carries), in a
    deterministic order. Names that resolve to immutable binds (or
    nothing) are body-local declarations — not carried."""
    return [n for n in sorted(comp_writes(comp))
            if _resolves_ref(env, n)]


def _staged_branch(comp: ir.Branch, pred, env: ir.Env, st: _St):
    """A branch on a lane value: both arms run, each from the same
    state, and every written cell, the cursor and the output take the
    arm the lane's condition picks (the reference's lax.cond, which
    vmap also turns into a select)."""
    if st.spy is not None:
        _stage(comp.then, env, st)
        _stage(comp.els, env, st)
        return None
    names = _carry_refs(comp, env)
    before = [env.lookup(n) for n in names]
    arms = []
    for body in (comp.then, comp.els):
        for n, v in zip(names, before):
            env.set(n, v)
        s2 = _St(st.chunk, st.pos, st.out_buf, st.out_n)
        if _stage(body, env, s2) is not None:
            raise _Unstageable("branch arm value with a lane-dependent "
                               "condition")
        arms.append((s2, [env.lookup(n) for n in names]))
    (s1, v1), (s2, v2) = arms
    c = E._t(pred, st.chunk.device).to(torch.bool)
    for n, a, b in zip(names, v1, v2):
        env.set(n, _select(c, a, b))
    st.pos = torch.where(c, s1.pos, s2.pos)
    if st.out_buf is not None:
        st.out_n = torch.where(c, s1.out_n, s2.out_n)
        st.out_buf = _select(c, s1.out_buf, s2.out_buf)
    return None


# ------------------------------------------------------------ machine


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


def _iters_per_block(weight: int) -> int:
    """Masked iterations per eager block or captured graph: light bodies
    (a sample walk) run many between host reads, heavy ones (a symbol's
    DSP) few, so a capture stays short."""
    return max(4, min(64, 2048 // max(1, weight)))


def _host_digest(v) -> tuple:
    """A hashable image of a host value (a static name's value)."""
    if isinstance(v, dict):
        return tuple(sorted((k, _host_digest(x)) for k, x in v.items()))
    if isinstance(v, torch.Tensor):
        raise _Unstageable("a loop bound is a device value")
    a = np.asarray(v)
    return (a.dtype.str, a.shape, a.tobytes())


class _Graph:
    """One captured block of masked iterations over static tensors."""

    __slots__ = ("graph", "state", "inputs", "keep")


class _Machine:
    """The lane-batched step of one (loop, key): the masked iteration,
    its plain eager driver and, on a CUDA device, its captured graphs."""

    def __init__(self, node: "_ChunkLoop", struct, names: List[str],
                 name_idx: Dict[str, int], take_b: int, out_cap: int,
                 is_for: bool, iter_cap: int, device):
        self.node = node
        self.struct = struct
        self.names = names
        self.carry_idx = [name_idx[m] for m in names]
        flat: List[str] = []
        for vn, rn, _w in struct:
            flat.extend(vn)
            flat.extend(rn)
        statics = _static_names(node.orig.body)
        carried = set(self.carry_idx)
        self.static_idx = [i for i, m in enumerate(flat)
                           if i not in carried and m in statics]
        self.batched_idx = [i for i in range(len(flat))
                            if i not in carried
                            and i not in self.static_idx]
        self.take_b = take_b
        self.out_cap = out_cap
        self.is_for = is_for
        self.iter_cap = iter_cap
        self.device = torch.device(device)
        self.m = _iters_per_block(_body_weight(node.orig.body))
        self.item = None          # (shape, dtype) of an emitted item
        self.dts: Optional[List[torch.dtype]] = None
        self.graphs: Dict[tuple, _Graph] = {}
        self.ok = False           # the discovery pass ran

    def static_key(self, vals) -> tuple:
        """The host values a lane's step bakes in (its batch group)."""
        return tuple(_host_digest(vals[i]) for i in self.static_idx)

    # ---------------------------------------------------- iteration

    def _env(self, carries, others, statics) -> ir.Env:
        """One lane's env chain: its carries, its batched values and the
        step's host values, each at its place in the sliced env."""
        from ziria_tpu_torch.backend.hybrid import _env_rebuild
        vals: List[Any] = [None] * (len(self.carry_idx)
                                    + len(self.batched_idx)
                                    + len(self.static_idx))
        for idx, vs in ((self.carry_idx, carries),
                        (self.batched_idx, others),
                        (self.static_idx, statics)):
            for i, v in zip(idx, vs):
                vals[i] = v
        return _env_rebuild(self.struct, vals)

    def _iterate(self, statics):
        """The one-lane masked iteration, for torch.func.vmap."""
        body = self.node.orig.body
        cond = None if self.is_for else self.node.orig.cond
        var = self.node.orig.var if self.is_for else None
        take_b, iter_cap, out_cap = self.take_b, self.iter_cap, \
            self.out_cap
        dts = self.dts

        def one(chunk, avail, n, it0, it, pos, out_n, done, out_buf,
                carries, others):
            env = self._env(carries, others, statics)
            fits = pos + take_b <= avail
            if cond is None:
                go = it < n
            else:
                go = E._t(ir.eval_expr(cond, env), chunk.device).to(
                    torch.bool)
                if iter_cap:
                    go = go & (it - it0 < iter_cap)
            active = go & fits & ~done
            st = _St(chunk, pos, out_buf if out_cap else None,
                     out_n if out_cap else None)
            e = env
            if var is not None:
                e = env.child()
                e.bind(var, it)
            if _stage(body, e, st) is not None:
                raise _Unstageable("loop body value is used")
            new = []
            for m, dt, old in zip(self.names, dts, carries):
                v = E._t(env.lookup(m), chunk.device)
                if v.is_complex() and not dt.is_complex:
                    v = v.real
                new.append(torch.where(active, v.to(dt), old))
            out = (torch.where(active, it + 1, it),
                   torch.where(active, st.pos, pos),
                   torch.where(active, st.out_n, out_n) if out_cap
                   else out_n,
                   done | ~active,
                   torch.where(active, st.out_buf, out_buf) if out_cap
                   else out_buf,
                   tuple(new))
            return out

        return one

    def _block(self, statics, state, inputs, k: int):
        """`k` masked iterations of every lane, eagerly (no host read)."""
        one = torch.func.vmap(self._iterate(statics))
        chunk, avail, n, it0, others = inputs
        it, pos, out_n, done, out_buf, carries = state
        with E.device_mode("vmap", self.device):
            for _ in range(k):
                it, pos, out_n, done, out_buf, carries = one(
                    chunk, avail, n, it0, it, pos, out_n, done, out_buf,
                    carries, others)
        return [it, pos, out_n, done, out_buf, carries]

    def _discover(self, statics, state, inputs) -> None:
        """Stage one iteration of lane 0 before the loop runs: learn the
        emitted item's dtype and shape, and surface a body the stager
        cannot express (_Unstageable) before any state changes."""
        chunk, _avail, _n, _it0, others = inputs
        carries = state[5]
        node = self.node
        spy: List[Any] = []

        def probe(chunk, carries, others):
            env = self._env(carries, others, statics)
            zero = torch.zeros((), dtype=torch.int32, device=chunk.device)
            st = _St(chunk, zero, None, None,
                     spy=spy if self.out_cap else None)
            e = env
            if self.is_for and node.orig.var is not None:
                e = env.child()
                e.bind(node.orig.var, zero)
            if not self.is_for:
                E._t(ir.eval_expr(node.orig.cond, env), chunk.device)
            _stage(node.orig.body, e, st)
            return (zero,) + tuple(E._t(v, chunk.device) for v in spy)

        lane0 = (chunk[:1], tuple(c[:1] for c in carries),
                 tuple(o[:1] for o in others))
        with E.device_mode("vmap", self.device):
            try:
                got = torch.func.vmap(probe)(*lane0)[1:]
            except E.DeviceControlError as ex:
                # the body reads a lane value on the host: structural
                raise _Unstageable(f"host read in the body: {ex}") from ex
        if self.out_cap:
            if not got:
                raise _Unstageable("emit bound > 0 but no emission site "
                                   "reached in discovery")
            shape = tuple(got[0].shape[1:])
            dt = got[0].dtype
            for g in got[1:]:
                if tuple(g.shape[1:]) != shape:
                    raise _Unstageable("emission shapes disagree")
                dt = torch.promote_types(dt, g.dtype)
            self.item = (shape, dt)

    # ---------------------------------------------------- driver

    def _inputs(self, lanes):
        """Stack the lanes' operands on the device (lane axis first)."""
        dev = self.device
        if self.take_b:
            chunk = E._t(np.stack([a[0] for a in lanes]), dev)
        else:
            chunk = torch.zeros((len(lanes), 1), dtype=torch.int32,
                                device=dev)
        ctr = torch.from_numpy(np.asarray(
            [[a[1], a[2], a[3]] for a in lanes], np.int32)).to(dev)
        avail, n, it0 = ctr[:, 0], ctr[:, 1], ctr[:, 2]

        def stack(idx):
            vs = [a[4][idx] for a in lanes]
            if isinstance(vs[0], dict):
                raise _Unstageable("a struct value in a chunk step")
            if any(isinstance(v, torch.Tensor) for v in vs):
                return torch.stack([E._t(v, dev) for v in vs])
            return E._t(np.stack([np.asarray(v) for v in vs]), dev)

        carries = [stack(i) for i in self.carry_idx]
        if self.dts is None:
            self.dts = [c.dtype for c in carries]
        carries = tuple(c.to(dt) for c, dt in zip(carries, self.dts))
        others = tuple(stack(i) for i in self.batched_idx)
        statics = [lanes[0][4][i] for i in self.static_idx]
        z = torch.zeros(len(lanes), dtype=torch.int32, device=dev)
        out_buf = z
        if self.out_cap:
            shape, dt = self.item if self.item else ((), torch.int32)
            out_buf = torch.zeros((len(lanes), self.out_cap) + shape,
                                  dtype=dt, device=dev)
        state = [it0.clone(), z.clone(), z.clone(),
                 torch.zeros(len(lanes), dtype=torch.bool, device=dev),
                 out_buf, carries]
        return statics, state, (chunk, avail, n, it0, others)

    def _predicted(self, lanes) -> int:
        """Iterations a For step surely runs on its longest lane (every
        iteration takes at most take_b): the replays to chain before the
        first host read."""
        if not self.is_for:
            return 1
        best = 0
        for a in lanes:
            k = a[2] - a[3]
            if self.take_b:
                k = min(k, a[1] // self.take_b)
            best = max(best, k)
        return max(1, best)

    def run(self, lanes, graphs: Optional[bool] = None):
        """One step of every lane: [(chunk, avail, n, it, vals)] ->
        [(it, pos, out_n, emitted rows, written refs)]. `graphs` (default:
        on a CUDA device) runs the captured graph, else the eager loop."""
        L = len(lanes)
        padded = pad_lanes(lanes)
        statics, state, inputs = self._inputs(padded)
        E._CAPTURE["guard"] = True
        try:
            if not self.ok:
                self._discover(statics, state, inputs)
                if self.out_cap:       # the buffer at the learned dtype
                    statics, state, inputs = self._inputs(padded)
                self.ok = True
            on_card = self.device.type == "cuda"
            if on_card if graphs is None else (graphs and on_card):
                state = self._run_graph(statics, state, inputs, padded)
            else:
                state = self._run_eager(statics, state, inputs, padded)
        finally:
            E._CAPTURE["guard"] = False
        it, pos, out_n, _done, out_buf, carries = state
        meta = torch.stack([it, pos, out_n], 1)[:L].cpu().numpy()
        STATS["host_reads"] += 1
        rows = None
        if self.out_cap:
            k = int(meta[:, 2].max())
            if k:
                rows = out_buf[:L, :k].cpu().numpy()
                STATS["host_reads"] += 1
        out = []
        for i in range(L):
            k = int(meta[i, 2])
            out.append((int(meta[i, 0]), int(meta[i, 1]), k,
                        rows[i, :k] if rows is not None and k else None,
                        [c[i] for c in carries]))
        return out

    def _run_eager(self, statics, state, inputs, lanes):
        # a For step's first block stops at the iterations it surely
        # runs (a short loop need not pay a whole block of masked ones)
        k = min(self.m, self._predicted(lanes)) if self.is_for else self.m
        while True:
            state = self._block(statics, state, inputs, k)
            k = self.m
            STATS["eager_blocks"] += 1
            live = bool((~state[3]).any())
            STATS["host_reads"] += 1
            if not live:
                return state

    def _capture(self, statics, state, inputs) -> _Graph:
        """Capture one block of masked iterations over static copies of
        `state` and `inputs` (the other frame threads are parked in the
        batcher, so nothing else launches meanwhile)."""
        g = _Graph()
        g.state, g.inputs = _clone(state), _clone(inputs)
        g.keep = []
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):      # warm-up: caches, allocator
            self._block(statics, g.state, g.inputs, self.m)
        torch.cuda.current_stream(self.device).wait_stream(side)
        g.graph = torch.cuda.CUDAGraph()
        E._CAPTURE["keep"] = g.keep
        try:
            with torch.cuda.graph(g.graph,
                                  capture_error_mode="thread_local"):
                new = self._block(statics, g.state, g.inputs, self.m)
                _copy_into(g.state, new)
        finally:
            E._CAPTURE["keep"] = None
        STATS["captures"] += 1
        return g

    def _run_graph(self, statics, state, inputs, lanes):
        chunk = inputs[0]
        gkey = (len(lanes), tuple(chunk.shape), str(chunk.dtype),
                tuple((tuple(c.shape), str(c.dtype)) for c in state[5]),
                tuple((tuple(o.shape), str(o.dtype)) for o in inputs[4]),
                self.static_key(lanes[0][4]))
        g = self.graphs.get(gkey)
        if g is None:
            g = self._capture(statics, state, inputs)
            self.graphs[gkey] = g
        _copy_into(g.state, state)
        _copy_into(g.inputs, inputs)
        todo = -(-self._predicted(lanes) // self.m)
        while True:
            for _ in range(todo):
                g.graph.replay()
            STATS["replays"] += todo
            dispatch.record("chunked.replay", todo)
            live = bool((~g.state[3]).any())
            STATS["host_reads"] += 1
            if not live:
                break
            todo = 1 if self.is_for else min(64, 2 * todo)
        return _clone(g.state)


def _clone(x):
    """A copy of a (nested) list or tuple of tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(_clone(v) for v in x)


def _copy_into(dst, src) -> None:
    """Copy nested tensors `src` into the same structure `dst`."""
    for d, s in zip(dst, src):
        if isinstance(d, torch.Tensor):
            d.copy_(s)
        else:
            _copy_into(d, s)


# ------------------------------------------------------------ the node


class _ChunkLoop(ir.Comp):
    """A For/While stream-control loop compiled as a chunked state
    machine. Executed by the interpreter through the `run_gen` hook; a
    structural refusal (before the loop runs) interprets `self.orig`
    (the oracle semantics); a failing step raises."""

    def __init__(self, orig: ir.Comp, device="cuda"):
        object.__setattr__(self, "orig", orig)
        object.__setattr__(self, "device", torch.device(device))
        object.__setattr__(self, "_machines", {})
        object.__setattr__(self, "_broken", False)
        object.__setattr__(self, "_fb", None)

    def _fallback_comp(self) -> ir.Comp:
        """The interpreter fallback still runs its do-blocks on the
        device: a loop below the chunking threshold must not run slower
        than the plain hybrid executor would have run it."""
        if self._fb is None:
            from ziria_tpu_torch.backend.hybrid import hybridize
            object.__setattr__(
                self, "_fb", hybridize(self.orig, chunk_loops=False,
                                       device=self.device))
        return self._fb

    def label(self) -> str:
        return f"ChunkLoop({self.orig.label()})"

    def _get_machine(self, env, names, take_b: int, out_cap: int,
                     is_for: bool, iter_cap: int):
        from ziria_tpu_torch.backend.hybrid import _env_signature
        from ziria_tpu_torch.frontend.externals import viterbi_mode
        keep: Set[str] = set(names)
        _comp_reads(self.orig, keep)
        struct, vals = _env_signature(env, keep=keep)
        # the viterbi_soft ext reads its decode mode from the
        # environment, so the mode is part of a step's identity
        key = (struct, tuple(names), take_b, out_cap, is_for, iter_cap,
               viterbi_mode())
        if key not in self._machines:
            flat: List[str] = []
            for vn, rn, _w in struct:
                flat.extend(vn)
                flat.extend(rn)
            name_idx = {}
            for m in names:
                # innermost occurrence wins (matches Env.set semantics)
                for i in range(len(flat) - 1, -1, -1):
                    if flat[i] == m:
                        name_idx[m] = i
                        break
            self._machines[key] = _Machine(self, struct, names, name_idx,
                                           take_b, out_cap, is_for,
                                           iter_cap, self.device)
        return key, self._machines[key], vals

    def run_gen(self, env: ir.Env, source, xp=np):
        from ziria_tpu_torch.interp.interp import Source, _run

        orig = self.orig
        is_for = isinstance(orig, ir.For)

        def fallback():
            return _run(self._fallback_comp(), env, source, xp)

        if self._broken or not isinstance(source, Source):
            return (yield from fallback())

        # ---- per-execution bounds & the is-it-worth-it gate
        try:
            wset = comp_writes(orig.body)
            take_b = take_bound(orig.body, env, wset)
            emit_b = emit_bound(orig.body, env, wset)
            if is_for:
                n = int(ir.eval_expr(orig.count, env))
                if n <= 0:
                    return None
                if n * (take_b + emit_b) < MIN_ITEMS_FOR:
                    return (yield from fallback())
                out_cap = _bucket(n * emit_b) if emit_b else 0
            else:
                n = 0
                if emit_b:
                    # bound emissions per step by capping iterations:
                    # the step stops after iter_cap iterations, reports
                    # its counts, and the host re-enters
                    iter_cap = WHILE_OUT_ITEMS // emit_b
                    if iter_cap < 1:
                        raise _Unstageable("while emission bound "
                                           "exceeds the output budget")
                    iter_cap = min(iter_cap, 2048)
                    out_cap = _bucket(emit_b * iter_cap)
                else:
                    out_cap = 0
        except _Unstageable:
            return (yield from fallback())

        if is_for or not emit_b:
            iter_cap = 0
        cap = max(CHUNK_CAP, _bucket(take_b)) if take_b else 0
        if is_for and take_b:
            cap = min(cap, _bucket(max(1, n * take_b)))
            cap = max(cap, _bucket(take_b))

        try:
            names = _carry_refs(orig.body, env)
            if not is_for:
                ast = _closure_ast(orig.cond)
                if ast is None and callable(orig.cond):
                    raise _Unstageable("opaque while condition")
                if ast is not None:
                    from ziria_tpu_torch.frontend.elab import free_vars
                    names = names + [
                        m for m in sorted(free_vars(ast))
                        if m not in names and _resolves_ref(env, m)]
            key, mach, vals = self._get_machine(env, names, take_b,
                                                out_cap, is_for, iter_cap)
        except _Unstageable:
            return (yield from fallback())

        vals = list(vals)
        it = 0
        buf: List[Any] = []
        eof = False

        def host_cond() -> bool:
            if is_for:
                return it < n
            return bool(ir.eval_expr(orig.cond, env))

        def write_back(final: bool) -> None:
            wvals = [vals[i] for i in mach.carry_idx]
            if final:
                wvals = [_small_to_host(v) for v in wvals]
            for m, v in zip(names, wvals):
                env.set(m, v)

        while host_cond():
            if take_b:
                need = cap if not is_for else min(cap, (n - it) * take_b)
                if not eof and len(buf) < need:
                    got, eof = source.pull_block(need - len(buf))
                    buf.extend(got)
                if len(buf) < take_b:
                    # not enough input for one worst-case iteration: run
                    # ONE iteration on the interpreter (exact EOF
                    # semantics: it may consume fewer than the bound, or
                    # raise UpstreamDone out of this loop)
                    source.push_back(buf)
                    buf = []
                    e = env
                    if is_for and orig.var is not None:
                        e = env.child()
                        e.bind(orig.var, it)
                    yield from _run(self._fallback_comp().body, e,
                                    source, xp)
                    # the interpreter mutated carried refs in env:
                    # refresh vals so a later step does not clobber them
                    for m, i in zip(names, mach.carry_idx):
                        vals[i] = env.lookup(m)
                    it += 1
                    continue

            if take_b:
                avail = min(len(buf), cap)
                chunk = np.stack([_host_item(x) for x in buf[:cap]])
                if chunk.shape[0] < cap:
                    pad = np.zeros((cap - chunk.shape[0],)
                                   + chunk.shape[1:], chunk.dtype)
                    chunk = np.concatenate([chunk, pad], axis=0)
            else:
                avail = 0
                chunk = None

            try:
                new_it, consumed, out_k, rows, rvals = _step_call(
                    self, key, (chunk, avail, n, it, vals))
            except _Unstageable as ex:
                if mach.ok:
                    raise
                # refused by the discovery pass, before any state
                # changed: this loop runs on the interpreter from now on
                object.__setattr__(self, "_broken", True)
                DEMOTED.append((orig.label(), str(ex)))
                source.push_back(buf)
                write_back(final=True)
                return (yield from fallback())

            for i, v in zip(mach.carry_idx, rvals):
                vals[i] = v
            write_back(final=False)

            if out_k:
                for row in rows:
                    yield row
            if consumed:
                buf = buf[consumed:]
            progress = new_it > it or consumed > 0
            it = new_it
            if is_for and it >= n:
                break
            if not progress and take_b and len(buf) >= take_b:
                # guard said an iteration fits but none ran — a stager
                # bug; surface it rather than spin
                raise RuntimeError(
                    f"chunked loop made no progress with {len(buf)} "
                    f"items buffered (take_bound={take_b})")

        source.push_back(buf)
        write_back(final=True)
        return None


def _host_item(x):
    """A buffered stream item as numpy (items a device block left on
    the card come back here)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _small_to_host(v):
    """A written ref leaving the loop: small tensors back to numpy (the
    interpreter's per-item fast path), large ones stay on the device."""
    if isinstance(v, torch.Tensor) and v.numel() <= HOST_SMALL_MAX:
        a = v.detach().cpu().numpy()
        return a[()] if a.ndim == 0 else a
    return v


def wrap_loops(comp: ir.Comp, dump=None, device="cuda") -> ir.Comp:
    """Walk `comp`, replacing stageable stream-I/O For/While loops with
    _ChunkLoop nodes on `device` (called from backend.hybrid.hybridize)."""

    def walk(c: ir.Comp) -> ir.Comp:
        if isinstance(c, (ir.For, ir.While)) and has_stream_io(c.body):
            try:
                check_stageable(c.body)
                if isinstance(c, ir.While):
                    if callable(c.cond):
                        ast = _closure_ast(c.cond)
                        if ast is None:
                            raise _Unstageable("opaque while condition")
                        if _expr_has_effects(ast, getattr(c.cond, "z_ctx",
                                                          None), set()):
                            raise _Unstageable("effects in while "
                                               "condition")
                    if _body_weight(c.body) < MIN_WHILE_WEIGHT:
                        raise _Unstageable("while body too light")
                node = _ChunkLoop(
                    ir.map_children(c, lambda ch, _b: walk(ch)), device)
                if dump is not None:
                    dump(f"  chunked {c.label()}")
                return node
            except _Unstageable as e:
                if dump is not None:
                    dump(f"  loop {c.label()} stays interpreted: {e}")
        return ir.map_children(c, lambda ch, _b: walk(ch))

    return walk(comp)
