"""Hybrid executor: interpreter-driven stream control, do-blocks on
the device (counterpart of ziria_tpu/backend/hybrid.py).

The reference compiles EVERYTHING to C — including the dynamic control
the fused jit backend refuses (value-dependent branches, dynamic trip
counts, per-item takes; SURVEY.md §2.1 CgComp's state machines). The
middle ground: keep the streaming interpreter as the control driver
(items, binds, branches run on the host) but execute each *heavy
imperative do-block* on the device, over the environment it touches.
The flagship receiver (`examples/wifi_rx.zir`) is exactly this shape —
a few hundred samples of per-item control around multi-thousand-op DSP
blocks (LTS correlation, per-symbol FFT/equalize/demap) — so the hot
math runs as tensors on the card while header-driven dispatch stays
host-level and exact.

Mechanism: `hybridize(comp)` rewrites `ir.Return(closure)` nodes whose
attached surface statements (``closure.z_stmts``, set by the
elaborator) weigh above a threshold and carry no effects into
`_DeviceDo` wrappers. Per call, the wrapper slices the `ir.Env` chain
to the block's read/write set; if every value in it can live on the
device (numbers, arrays, tensors, structs of them) the block is placed
there before it runs: arrays move to the card (small values stay host
scalars), a chain of the same shape is rebuilt, the SAME evaluator
runs in device mode (one semantics, shared with the oracle), and the
written refs come back — tensors of 4096 elements or fewer as numpy,
larger ones (frame buffers) left on the card for the next block. A
block placed on the card that fails there raises: eager torch has no
staging step whose failure could be told apart from a real one (the
reference demotes a block on its first-call staging failure). A block
whose env holds a value with no device form runs on the host.

Blocks containing `print`/`println`/`error` are never wrapped (side
effects must fire per execution, and `error` must raise
data-dependently).

The stream-control loops that the reference's ``chunked.py`` turns
into device state machines are not ported (ROADMAP Queue 1 item 6b):
they run on the host interpreter, which is the reference's own
fallback for a loop it does not wrap and gives the same results.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

import torch

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.frontend import ast as A
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.utils import dispatch

# a do-block is worth a device round-trip when its (loop-weighted) op
# count clears this; below it host dispatch overhead wins
MIN_JIT_WEIGHT = 300

# written values at or below this many elements come back to numpy
HOST_LEAF_MAX = 4096

#: do-block executions since the last reset: on the device and on the
#: host (below the weight, with effects, or an env with no device form)
BLOCKS = {"device": 0, "host": 0}


def reset_counts() -> None:
    for k in BLOCKS:
        BLOCKS[k] = 0

# literal loop counts multiply body weight, capped so one huge loop
# does not dominate the decision arithmetic
_LOOP_W_CAP = 256


def _expr_weight(e: Optional[A.Expr]) -> int:
    if e is None:
        return 0
    base = 2 if isinstance(e, A.ECall) else 1
    return base + sum(_expr_weight(k) for k in A.child_exprs(e))


def _loop_mult(count: Optional[A.Expr]) -> int:
    if isinstance(count, A.EInt):
        return max(1, min(int(count.val), _LOOP_W_CAP))
    return 8                                  # unknown count: assume some


def _stmts_weight(stmts) -> int:
    w = 0
    for st in stmts:
        w += sum(_expr_weight(e) for e in A.stmt_exprs(st)) + 1
        if isinstance(st, A.SFor):
            w += _loop_mult(st.count) * (1 + _stmts_weight(st.body))
        elif isinstance(st, A.SWhile):
            w += 8 * (1 + _stmts_weight(st.body))
        elif isinstance(st, A.SIf):
            w += _stmts_weight(st.then) + _stmts_weight(st.els)
    return w


def _has_effects(stmts, ctx=None, _seen: Optional[set] = None) -> bool:
    """print/println/error anywhere in the block — including inside
    user functions it calls (recursing through ctx.funs, like the LUT
    purity analysis) — such blocks run on the host interpreter so
    effects fire in order with the stream's."""
    seen = _seen if _seen is not None else set()
    for e in A.iter_stmt_exprs(stmts):
        if not isinstance(e, A.ECall):
            continue
        if e.name in ("print", "println", "error"):
            return True
        if ctx is not None and e.name in getattr(ctx, "funs", {}) \
                and e.name not in seen:
            seen.add(e.name)
            if _has_effects(ctx.funs[e.name].decl.body, ctx, seen):
                return True
    return False


# ------------------------------------------------------------ env pytree


def _env_signature(env: ir.Env, keep=None,
                   writes=None) -> Tuple[Tuple, List[Any]]:
    """Flatten the env chain to (structure, values). Structure is a
    hashable per-level tuple of (var names, ref names, written-ref
    names) outermost-first; values align with the first two.

    `keep`/`writes` slice the env to the block's syntactic read/write
    sets: a do-block next to a 131072-entry frame buffer it never
    touches must not ship that buffer to the device and back on every
    firing (measured: the whole win disappeared into env traffic)."""
    levels = []
    e = env
    while e is not None:
        levels.append(e)
        e = e._parent
    levels.reverse()
    struct, vals = [], []
    for lv in levels:
        vnames = tuple(n for n in lv._vars
                       if keep is None or n in keep)
        rnames = tuple(n for n in lv._refs
                       if keep is None or n in keep)
        wnames = tuple(n for n in rnames
                       if writes is None or n in writes)
        struct.append((vnames, rnames, wnames))
        vals.extend(lv._vars[n] for n in vnames)
        vals.extend(lv._refs[n] for n in rnames)
    return tuple(struct), vals


def _env_rebuild(struct: Tuple, vals: List[Any]) -> ir.Env:
    env = None
    it = iter(vals)
    for vnames, rnames, _wn in struct:
        env = ir.Env(env)
        for n in vnames:
            env.bind(n, next(it))
        for n in rnames:
            env.bind_ref(n, next(it))
    return env


def _env_refs(env: ir.Env, struct: Tuple) -> List[Any]:
    """WRITTEN ref values in structure order (outermost level first)."""
    levels = []
    e = env
    while e is not None:
        levels.append(e)
        e = e._parent
    levels.reverse()
    out = []
    for lv, (_vn, _rn, wnames) in zip(levels, struct):
        out.extend(lv._refs[n] for n in wnames)
    return out


def _env_write_refs(env: ir.Env, struct: Tuple, vals: List[Any]) -> None:
    levels = []
    e = env
    while e is not None:
        levels.append(e)
        e = e._parent
    levels.reverse()
    it = iter(vals)
    for lv, (_vn, _rn, wnames) in zip(levels, struct):
        for n in wnames:
            lv._refs[n] = next(it)


def _device_form(v) -> bool:
    """Can `v` live on the device? Numbers, numpy arrays of numeric
    dtypes, tensors, structs of those, and None (the value of a bind
    whose computation returned nothing, an empty leaf)."""
    if v is None or isinstance(v, torch.Tensor):
        return True
    if isinstance(v, dict):
        return all(k == "__struct__" or _device_form(x)
                   for k, x in v.items())
    if isinstance(v, (bool, int, float, complex)):
        return True
    if isinstance(v, (np.ndarray, np.generic)):
        return np.asarray(v).dtype.kind in "biufc"
    return False


def _to_dev(v, dev):
    """An env value as the device block sees it: arrays (ndim >= 1) on
    the device at the canonical dtypes, 0-d values left as host
    scalars (control on them stays free of syncs)."""
    if isinstance(v, dict):
        return {k: (x if k == "__struct__" else _to_dev(x, dev))
                for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.to(dev) if v.dim() else v
    if isinstance(v, np.ndarray) and v.ndim >= 1:
        return E._t(v, dev)
    return v


def _from_dev(v):
    """A value leaving the block: tensors of HOST_LEAF_MAX elements or
    fewer come back as numpy (the interpreter's per-item work runs far
    faster on numpy), larger ones stay on the device."""
    if isinstance(v, dict):
        return {k: (x if k == "__struct__" else _from_dev(x))
                for k, x in v.items()}
    if isinstance(v, torch.Tensor) and v.numel() <= HOST_LEAF_MAX:
        E.COUNTS["syncs"] += 1
        a = v.detach().cpu().numpy()
        return a[()] if a.ndim == 0 else a
    return v


class _DeviceDo:
    """Wraps one do-block closure: env -> the same closure run in device
    mode over a device copy of the env slice it touches, with ref
    write-back. Placement is decided per call before the block runs."""

    def __init__(self, closure, device):
        self.closure = closure
        self.device = torch.device(device)
        # syntactic read/write sets slice the env: only touched names
        # cross the host<->device boundary per firing
        stmts = getattr(closure, "z_stmts", None)
        if stmts is not None:
            reads: set = set()
            writes: set = set()
            E._stmt_reads(stmts, reads)
            E._stmt_writes(stmts, writes)
            self._keep = frozenset(reads | writes)
            self._writes = frozenset(writes)
        else:                     # pragma: no cover - wrapped closures
            self._keep = self._writes = None
        # the z_* attributes keep the block visible to analyses
        self.z_stmts = stmts
        self.z_ctx = getattr(closure, "z_ctx", None)

    def __call__(self, env: ir.Env):
        struct, vals = _env_signature(env, self._keep, self._writes)
        if not all(_device_form(v) for v in vals):
            BLOCKS["host"] += 1
            return self.closure(env)
        BLOCKS["device"] += 1
        dev = self.device
        env2 = _env_rebuild(struct, [_to_dev(v, dev) for v in vals])
        from ziria_tpu_torch.ops.cplx import exact_fp32
        with E.device_mode("block", dev), exact_fp32(), torch.no_grad(), \
                dispatch.timed("hybrid.device_block"):
            ret = self.closure(env2)
        refs = [_from_dev(v) for v in _env_refs(env2, struct)]
        _env_write_refs(env, struct, refs)
        return _from_dev(ret)


class _HostDo:
    """A do-block left on the host (below the weight, or with
    effects): the closure itself, counted."""

    def __init__(self, closure):
        self.closure = closure
        self.z_stmts = getattr(closure, "z_stmts", None)
        self.z_ctx = getattr(closure, "z_ctx", None)

    def __call__(self, env: ir.Env):
        BLOCKS["host"] += 1
        return self.closure(env)


def hybridize(comp: ir.Comp, min_weight: int = MIN_JIT_WEIGHT,
              dump=None, chunk_loops: bool = True,
              device="cuda") -> ir.Comp:
    """Rewrite heavy do-blocks into `_DeviceDo` wrappers on `device`;
    everything else is untouched. Running the result on the interpreter
    gives hybrid execution. `dump`, if given, receives one line per
    decision (the --ddump-hybrid flag). `chunk_loops` asks for the
    reference's chunked stream-control loops (backend/chunked.py),
    which are not ported: every loop stays on the host interpreter and
    the dump says so."""
    import dataclasses

    def walk(c: ir.Comp) -> ir.Comp:
        if chunk_loops and dump is not None \
                and isinstance(c, (ir.While, ir.For, ir.Repeat)):
            dump(f"  loop {c.label()} -> host (chunked.py not ported)")
        if isinstance(c, ir.Return) and callable(c.expr):
            stmts = getattr(c.expr, "z_stmts", None)
            if stmts is None:
                return c
            ctx = getattr(c.expr, "z_ctx", None)
            w = _stmts_weight(stmts)
            fx = _has_effects(stmts, ctx)
            jit_it = not fx and w >= min_weight
            if dump is not None:
                loc = getattr(stmts[0], "loc", ("?", "?")) if stmts \
                    else ("?", "?")
                why = ("jit" if jit_it else
                       "effects" if fx else f"below {min_weight}")
                dump(f"  do-block @{loc[0]}:{loc[1]} weight={w} "
                     f"-> {why}")
            wrapped = _DeviceDo(c.expr, device) if jit_it \
                else _HostDo(c.expr)
            return dataclasses.replace(c, expr=wrapped)
        return ir.map_children(c, lambda ch, _b: walk(ch))

    return walk(comp)


def run_hybrid(comp: ir.Comp, inputs, max_out: Optional[int] = None,
               min_weight: int = MIN_JIT_WEIGHT, device="cuda"):
    """Interpreter driver over the hybridized program."""
    from ziria_tpu_torch.interp.interp import run
    return run(hybridize(comp, min_weight, device=device), inputs,
               max_out=max_out)
