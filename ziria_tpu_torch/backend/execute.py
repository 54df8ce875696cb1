"""Execute a lowered pipeline over a finite input stream (counterpart
of ziria_tpu/backend/execute.py).

The analogue of the reference's driver main loop (SURVEY.md §3.2): where
that loop ticks the compiled state machine once per (vectorized) chunk,
this packs the bulk of the stream into a ``(T, chunk, ...)`` tensor on
the device and runs the step over it chunk by chunk — the host touches
the data twice (feed, fetch), everything in between stays on the
device.

Tail semantics match the reference's *vectorized* mode: input that doesn't
fill a whole steady-state iteration produces no output (the vectorized
read fails at EOF and the pipeline terminates). Full iterations beyond the
last bulk chunk are processed too, so no whole iteration is dropped; the
interpreter oracle agrees with this on any input whose length is a
multiple of the steady-state take count. Where the reference scans a
width-1 step over those remaining iterations, the port runs them as ONE
step of that many iterations: a stateless stage's firings are
independent and a stateful stage runs its firings in order either way,
so the outputs and the carry are the same.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.backend.lower import (Lowered, LowerError, _to_device,
                                           lower)
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.ops.cplx import exact_fp32
from ziria_tpu_torch.utils import dispatch

__all__ = ["Lowered", "LowerError", "lower", "run_jit", "run_jit_carry",
           "run_vect"]


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def run_jit(comp: ir.Comp, inputs, width: Optional[int] = None,
            target_items: int = 8192, optimize: bool = False,
            device="cuda") -> np.ndarray:
    """Run pipeline `comp` over `inputs` (array, leading axis = stream) on
    the jit backend, on `device`; returns the output stream as a numpy
    array.

    `optimize=True` runs the fold/fusion pass (core/opt.py) first — the
    reference's `--fold` flag; output is invariant (tested) but folded
    programs can lower where raw ones can't (const branches) and fuse to
    fewer stages."""
    ys, _ = run_jit_carry(comp, inputs, width=width,
                          target_items=target_items, optimize=optimize,
                          device=device)
    return ys


def run_jit_carry(comp: ir.Comp, inputs, carry=None,
                  width: Optional[int] = None, target_items: int = 8192,
                  optimize: bool = False, stats_out: Optional[dict] = None,
                  device="cuda"):
    """Like run_jit, but stream-resumable: returns ``(outputs, carry)``
    where carry is ``{"stages": <per-stage states>, "leftover": <input
    items not yet forming a full steady-state iteration>}``. Feeding a
    stream in pieces with the carry threaded through produces exactly
    the one-shot output for ANY chunk boundaries — sub-iteration
    remainders ride along in "leftover" instead of being dropped (the
    vectorized-EOF drop applies only to the true end of stream). The
    carry's structure is width-independent, so chunk sizes may differ
    call to call."""
    if optimize:
        from ziria_tpu_torch.core.opt import fold
        comp = fold(comp)
    dev = torch.device(device)
    inputs = np.asarray(inputs)
    stage_carry = None
    if carry is not None:
        if isinstance(carry, dict):
            if "stages" not in carry:
                raise ValueError(
                    "carry dict has no 'stages' key — not a "
                    "run_jit_carry carry")
            stage_carry = carry["stages"]
            lef = carry.get("leftover")
            lef = np.empty(0) if lef is None else np.asarray(lef)
            if lef.size:
                # the leftover's dtype/item-shape are authoritative (it
                # came from the same stream); never silently cast in a
                # lossy direction
                if inputs.shape[0] == 0:
                    inputs = lef
                elif inputs.shape[1:] != lef.shape[1:]:
                    raise ValueError(
                        f"resumed chunk item shape {inputs.shape[1:]} "
                        f"does not match the checkpoint leftover's "
                        f"{lef.shape[1:]}")
                else:
                    if inputs.dtype != lef.dtype and not np.can_cast(
                            inputs.dtype, lef.dtype, casting="safe"):
                        raise ValueError(
                            f"resumed chunk dtype {inputs.dtype} cannot "
                            f"be losslessly cast to the checkpoint "
                            f"leftover's {lef.dtype}; cast the chunk "
                            f"explicitly if the narrowing is intended")
                    inputs = np.concatenate(
                        [lef, inputs.astype(lef.dtype, copy=False)],
                        axis=0)
        else:                       # bare stage states (no leftover)
            stage_carry = carry
    big = lower(comp, width=width, target_items=target_items, device=dev)
    n_iters = inputs.shape[0] // big.ss.take
    n_bulk = n_iters // big.width
    rem_iters = n_iters - n_bulk * big.width
    if stats_out is not None:
        # the executed plan, from the executor's own arithmetic (the CLI
        # --stats report prints this rather than re-deriving the split)
        stats_out.update(
            width=big.width, take=big.take, emit=big.emit,
            labels=big.labels, reps=big.ss.reps, n_iters=n_iters,
            bulk_steps=n_bulk, remainder_iters=rem_iters)
    outs = []

    if stage_carry is None:
        carry = big.init_carry
    else:
        carry = _to_device(stage_carry, dev)

    with exact_fp32(), torch.no_grad():
        if n_bulk:
            bulk = inputs[: n_bulk * big.take].reshape(
                (n_bulk, big.take) + inputs.shape[1:])
            with dispatch.timed("execute.scan_bulk"):
                carry, ys = big.scan_steps()(carry, E._t(bulk, dev))
            ys = _to_host(ys)
            outs.append(ys.reshape((n_bulk * big.emit,) + ys.shape[2:]))

        if rem_iters:
            # the remaining full iterations as one step of their width;
            # the carry's structure is width-independent, so the bulk
            # carry threads on
            small = lower(comp, width=rem_iters, device=dev)
            pos = n_bulk * big.take
            rem = inputs[pos: pos + small.take]
            with dispatch.timed("execute.scan_rem"):
                carry, ys = small.step(carry, E._t(rem, dev))
            outs.append(_to_host(ys))

    leftover = inputs[n_iters * big.ss.take:]
    carry_out = {"stages": carry, "leftover": np.asarray(leftover)}
    if not outs:
        # no full steady-state iteration: no output yet; the items wait
        # in leftover (they are only dropped at true end-of-stream — the
        # vectorized-EOF rule). Item shape of the output is unknown
        # without running, so report 0 items with the input's item shape
        return np.empty((0,) + inputs.shape[1:]), carry_out
    return np.concatenate(outs, axis=0), carry_out


def run_vect(comp: ir.Comp, inputs, plan=None, optimize: bool = False,
             item_bytes: int = 4, device="cuda") -> np.ndarray:
    """Run a pipeline under the vectorizer's plan (core/vectorize.py)
    on `device`.

    Static segments run fused on the jit backend at their searched
    widths; dynamic segments (no static cardinality) on the hybrid
    backend (interpreter-driven control, heavy do-blocks and chunk
    machines on the device); the host boundary between segments is the
    mitigator. A fully static pipeline is ``run_jit`` at the planned
    width, a fully dynamic one the hybrid executor."""
    from ziria_tpu_torch.core.vectorize import vectorize

    if optimize:
        from ziria_tpu_torch.core.opt import fold
        comp = fold(comp)
    if plan is None:
        plan = vectorize(comp, item_bytes=item_bytes, device=device)
    stream = np.asarray(inputs)
    for seg in plan.segments:
        if seg.dynamic:
            from ziria_tpu_torch.backend.hybrid import run_hybrid
            stream = _to_host(run_hybrid(seg.comp, stream,
                                         device=device).out_array())
        else:
            stream = run_jit(seg.comp, stream, width=seg.width,
                             device=device)
        if stream.shape[0] == 0:
            return stream
    return stream
