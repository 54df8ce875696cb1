"""The jit backend's lowering: fuse a static-rate pipeline into one step
function (counterpart of ziria_tpu/backend/lower.py).

Where the reference compiles each component to C init/tick/process state
machines glued by buffer calls (SURVEY.md §2.1 CgMonad/CgExpr and §3.2's
tick/process hot loop), this backend turns the *whole* static-cardinality
pipeline segment into a single function

    step : (carry, in_chunk) -> (carry, out_chunk)

over tensors on the device. The synchronous-dataflow steady state
(core/card.py) gives each stage a firing count per iteration; a planner
width ``W`` multiplies that by how many steady-state iterations one
step processes. Per stage:

- stateless stages (``Map``, ``Repeat`` of a static computer) become
  ``reshape (F, arity, ...) -> torch.func.vmap -> reshape`` — F =
  reps*W parallel firings, the analogue of the reference vectorizer's
  widened take/emit arrays;
- stateful stages (``MapAccum``, ``JaxBlock``) run their F firings in
  order, one eager call each (sequential by data dependence, exactly
  like the reference's stateful blocks; the reference scans them);
- ``Repeat`` bodies are turned into firing functions by *running the
  interpreter* on tensors — the oracle and the compiler share one
  semantics, so they cannot drift.

A firing body whose own control depends on its data (a ``while``
condition or a loop bound that differs per firing, which the reference
stages as ``lax.while_loop``/``fori_loop`` under vmap) cannot run as
one vmapped call: its stage runs each firing on its own, in order, on
the device, as the stateful stages do. A Python callable that branches
on a batched value refuses with a ``LowerError`` and the reference's
guidance, as the reference's tracer does, and the CLI then runs the
program on the hybrid backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.card import CCard, SteadyState, cardinality, \
    steady_state
from ziria_tpu_torch.core.ir import Env
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.interp.interp import _run
from ziria_tpu_torch.utils import txp


class LowerError(Exception):
    """A pipeline (segment) can't be lowered to the jit backend. The
    message says which node and why; such programs still run on the
    interpreter and hybrid backends."""


_DATA_DEPENDENT = (
    "has data-dependent control flow; express it with a select inside a "
    "map/jax_block instead, or run on the interpreter backend")


def _is_vmap_control(e: BaseException) -> bool:
    """torch.func.vmap's refusal of a data-dependent host read
    (bool()/item() of a batched tensor)."""
    msg = str(e)
    return isinstance(e, RuntimeError) and "vmap" in msg and (
        "data-dependent" in msg or ".item()" in msg
        or "Tensor to boolean" in msg)


# --------------------------------------------------------------------------
# Computer body -> firing function, by running the interpreter
# --------------------------------------------------------------------------


def firing_fn(body: ir.Comp) -> Tuple[Callable, int, int]:
    """Build ``fire(in_items) -> out_items`` for a static computer body.

    in_items has shape (take, *item); out_items (emit, *item_out) — for
    take/emit == 1 the bare item is used. The body is executed by the
    streaming interpreter with tensor values; under vmap, control in
    its code that differs per firing raises ``DeviceControlError``
    (:func:`_apply_parallel` then runs it per firing), control in a
    Python callable ``LowerError`` with guidance.
    """
    c = cardinality(body)
    if not isinstance(c, CCard):
        raise LowerError(
            f"cannot lower computer body {body.label()}: cardinality is "
            f"not static")
    n_take, n_emit = c.take, c.emit
    if n_emit == 0:
        raise LowerError(
            f"cannot lower pure-sink body {body.label()} (emits nothing): "
            f"jit segments produce output chunks; run sink computations on "
            f"the interpreter backend")

    def fire(in_items):
        idx = [0]

        def src():
            if idx[0] >= n_take:
                raise LowerError(
                    f"body {body.label()} took more than its static "
                    f"cardinality {n_take}")
            x = in_items if n_take == 1 else in_items[idx[0]]
            idx[0] += 1
            return x

        outs = []
        gen = _run(body, Env(), src, xp=txp)
        try:
            while True:
                outs.append(next(gen))
        except StopIteration:
            pass
        except E.DeviceControlError:
            raise
        except RuntimeError as e:
            if _is_vmap_control(e):
                raise LowerError(
                    f"body {body.label()} {_DATA_DEPENDENT}") from e
            raise
        if len(outs) != n_emit:
            raise LowerError(
                f"body {body.label()} emitted {len(outs)} items, static "
                f"cardinality says {n_emit}")
        if n_emit == 1:
            return txp.asarray(outs[0])
        return txp.stack(outs)

    return fire, n_take, n_emit


# --------------------------------------------------------------------------
# Per-stage lowering
# --------------------------------------------------------------------------


def _apply_parallel(f: Callable, chunk, a: int, b: int, F: int):
    """Apply stateless per-firing f over F firings packed in `chunk`
    ((F*a, *item) -> (F*b, *item_out)) via reshape + torch.func.vmap.
    When f's own code branches per firing (``DeviceControlError``: a
    ``while`` condition or a loop bound, which the reference stages as
    ``lax.while_loop``/``fori_loop`` under vmap) the F firings run one
    eager call each, in order, as :func:`_apply_scan` runs a stateful
    stage's."""
    xs = chunk if a == 1 else chunk.reshape((F, a) + tuple(chunk.shape[1:]))

    def one(x):
        try:
            return txp.asarray(f(x))
        except E.DeviceControlError:
            raise
        except RuntimeError as e:
            if _is_vmap_control(e):
                raise LowerError(_DATA_DEPENDENT) from e
            raise

    try:
        with E.device_mode("vmap", xs.device):
            ys = torch.func.vmap(one)(xs)
    except E.DeviceControlError:
        with E.device_mode("block", xs.device):
            ys = txp.stack([txp.asarray(f(xs[k])) for k in range(F)])
    return ys if b == 1 else ys.reshape((F * b,) + tuple(ys.shape[2:]))


def _apply_scan(f: Callable, state, chunk, a: int, b: int, F: int):
    """Apply stateful per-firing f over F firings in order (the
    reference's lax.scan): one eager call per firing, inside a device
    block, the state threaded through."""
    xs = chunk if a == 1 else chunk.reshape((F, a) + tuple(chunk.shape[1:]))
    ys = []
    with E.device_mode("block", xs.device):
        for k in range(F):
            state, y = f(state, xs[k])
            ys.append(y)
    ys = txp.stack(ys)
    return state, (ys if b == 1 else ys.reshape((F * b,)
                                                + tuple(ys.shape[2:])))


def _to_device(v, device):
    """A stage state (or carry) on `device`: tensors at the canonical
    dtypes, structure (tuples, lists, dicts) kept."""
    if isinstance(v, tuple):
        return tuple(_to_device(x, device) for x in v)
    if isinstance(v, list):
        return [_to_device(x, device) for x in v]
    if isinstance(v, dict):
        return {k: (x if k == "__struct__" else _to_device(x, device))
                for k, x in v.items()}
    if v is None:
        return None
    return E._t(v, device)


@dataclass
class _Stage:
    fn: Callable  # (state, chunk) -> (state, out_chunk)
    init_state: Any
    label: str


def _lower_stage(stage: ir.Comp, F: int, device) -> _Stage:
    if isinstance(stage, ir.Map):
        a, b = stage.in_arity, stage.out_arity

        def fn(state, chunk, _f=stage.f, _a=a, _b=b, _F=F):
            return state, _apply_parallel(_f, chunk, _a, _b, _F)

        return _Stage(fn, None, stage.label())

    if isinstance(stage, (ir.MapAccum, ir.JaxBlock)):
        a, b = stage.in_arity, stage.out_arity

        def fn(state, chunk, _f=stage.f, _a=a, _b=b, _F=F):
            return _apply_scan(_f, state, chunk, _a, _b, _F)

        init = _to_device(stage.init_state(), device)
        return _Stage(fn, init, stage.label())

    if isinstance(stage, ir.Repeat):
        fire, a, b = firing_fn(stage.body)
        if a == 0:
            raise LowerError(
                "cannot lower a pure-source repeat inside a fused segment")

        def fn(state, chunk, _f=fire, _a=a, _b=b, _F=F):
            return state, _apply_parallel(_f, chunk, _a, _b, _F)

        return _Stage(fn, None, f"repeat({stage.body.label()})")

    raise LowerError(
        f"stage {stage.label()} ({type(stage).__name__}) is not lowerable: "
        f"jit segments are built from Map/MapAccum/JaxBlock/Repeat-of-"
        f"static-computer; run dynamic structure on the interpreter or "
        f"wrap it in a jax_block")


# --------------------------------------------------------------------------
# Whole-pipeline lowering
# --------------------------------------------------------------------------


@dataclass
class Lowered:
    """A fused pipeline segment: call ``step(carry, in_chunk)``; in_chunk
    carries ``take`` items (leading axis), out ``emit`` items."""

    step: Callable
    init_carry: Tuple
    take: int
    emit: int
    width: int
    ss: SteadyState
    labels: Tuple[str, ...]

    def scan_steps(self):
        """(carry, chunks[T, take, ...]) -> (carry, outs[T, emit, ...]):
        the steps of a stream's bulk, one after another."""

        def many(carry, chunks):
            outs = []
            for t in range(chunks.shape[0]):
                carry, y = self.step(carry, chunks[t])
                outs.append(y)
            return carry, torch.stack(outs)

        return many


def plan_width(ss: SteadyState, target_items: int = 8192) -> int:
    """Pick how many steady-state iterations one step processes.

    The reference's vectorizer searches per-segment (in,out) scale factors
    with a utility model (SURVEY.md §2.1 VecSF); here the considerations
    collapse to "make the fused chunk big enough to fill the device and
    amortize launches": default to ~target_items items per chunk.
    """
    per_iter = max(ss.take, ss.emit, 1)
    return max(1, target_items // per_iter)


def lower(comp: ir.Comp, width: Optional[int] = None,
          target_items: int = 8192, device="cuda") -> Lowered:
    """Lower a static-rate pipeline to a fused step function whose
    stage states live on `device`."""
    stages = ir.pipeline_stages(comp)
    ss = steady_state(stages)
    if ss is None:
        raise LowerError(
            "pipeline has no static steady state; stages: "
            + ", ".join(s.label() for s in stages))
    W = width if width is not None else plan_width(ss, target_items)
    dev = torch.device(device)
    lowered = [_lower_stage(s, r * W, dev) for s, r in zip(stages, ss.reps)]
    init_carry = tuple(s.init_state for s in lowered)

    def step(carry, chunk):
        new_carry = []
        for st, c in zip(lowered, carry):
            c, chunk2 = st.fn(c, chunk)
            new_carry.append(c)
            chunk = chunk2
        return tuple(new_carry), chunk

    return Lowered(step=step, init_carry=init_carry, take=ss.take * W,
                   emit=ss.emit * W, width=W, ss=ss,
                   labels=tuple(s.label for s in lowered))
