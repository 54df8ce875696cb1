"""Stage-parallel pipelines: ``|>>>|`` on a mesh axis (counterpart of
ziria_tpu/parallel/stages.py).

The reference runs each ``|>>>|`` segment on a core of its own with
SPSC queues between them (SURVEY.md §3.3). Here each segment is fused
by the jit backend (``backend/lower.py``) with its state on one entry
of a mesh axis, and chunks advance from segment to segment each macro
step:

- every entry k keeps its own segment's carry and steps only that;
- the K-1 boundary slots move from entry k to entry k+1 after each
  macro step (``mesh.ppermute``), each boundary in its own dtype and
  shape (no flattened float carrier);
- the last segment's output is copied to the caller, which is what the
  reference's masked ``psum`` replicates, exactly and in its own dtype
  (a bool stays a bool).

With K segments, output m belongs to input m-(K-1): the driver feeds K-1
trailing dummy chunks and trims the first K-1 outputs (the pipeline's
fill and drain). Input m reaches segment k at macro step m+k, so segment
k is live for k <= m < m_real + k; outside that window it does not step
its carry, and the exit carries equal the sequential run's. The
segments run one after another in the calling process, each on its
entry's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from math import gcd
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ziria_tpu_torch.backend.lower import LowerError, lower
from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.card import TCard, cardinality
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.ops.cplx import exact_fp32
from ziria_tpu_torch.parallel.mesh import (Mesh, allgather_parts, ppermute,
                                           process_rank)


def _segment_widths(segs: Sequence[ir.Comp], width: int) -> list:
    """Per-segment lowering widths that rate-match every boundary: the
    boundary between k and k+1 balances when emit_k * w_k == take_{k+1}
    * w_{k+1} (the steady-state solve of core/card, one level up)."""
    rates = []
    for s in segs:
        c = cardinality(s)
        if not isinstance(c, TCard) or c.i == 0 or c.o == 0:
            raise LowerError(
                f"stage-parallel segment {s.label()} needs a static "
                f"transformer rate with nonzero input and output")
        rates.append(c)
    w = [1] * len(segs)
    for k in range(len(segs) - 1):
        prod = rates[k].o * w[k]
        need = rates[k + 1].i
        lcm = prod * need // gcd(prod, need)
        if lcm // prod != 1:
            for j in range(k + 1):
                w[j] *= lcm // prod
            prod = lcm
        w[k + 1] = prod // need
    return [wi * width for wi in w]


@dataclass
class PPLowered:
    """A stage-parallel pipeline bound to a mesh axis.

    ``run(xs)``: xs (M, take, *item) -> (M, emit, *out_item), numpy; M
    macro steps in, M out (fill and drain handled inside).

    ``run_carry(xs)``: (ys, carry), the carry a ``run_jit_carry`` carry
    whose "stages" follow ``lower(pipe(*segments))``'s stage order, so a
    remainder shorter than a macro chunk continues on one device with
    the exact state. With ``batch_axis``, xs is (B, M, take, *item) and
    the carry a list of such dicts, one per stream."""

    run: Callable
    run_carry: Callable
    take: int
    emit: int
    n_stages: int
    labels: Tuple[str, ...]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def lower_stage_parallel(comp: ir.Comp, mesh: Mesh, axis: str = "pp",
                         in_item=None, width: int = 1,
                         batch_axis: Optional[str] = None) -> PPLowered:
    """Lower a ``|>>>|`` pipeline onto `mesh`'s `axis`, one segment an
    entry (their counts must be equal).

    `in_item` is the (shape, dtype) of one input item (default: a
    float32 scalar); each macro chunk's items must have that shape.
    With ``batch_axis`` (a second axis of a 2-D mesh, such as dp of a
    (dp, pp) mesh), ``run`` takes a batch of independent streams
    (B, M, take, *item) split over `batch_axis`, each stream piped
    through the pp entries of its dp row. The pp axis must lie in one
    process; the batch axis may span processes (each runs its rows)."""
    segs = ir.par_segments(comp)
    K = len(segs)
    n_dev = mesh.shape[axis]
    if K != n_dev:
        raise LowerError(
            f"{K} |>>>| segments but mesh axis {axis!r} has {n_dev} "
            f"devices; split the pipeline to match (or batch frames over "
            f"'dp' instead)")
    mesh.require_local(axis, "each macro step moves every boundary "
                             "chunk to the next stage")
    item_shape = tuple(in_item[0]) if in_item is not None else ()
    widths = _segment_widths(segs, width)
    if batch_axis is None:
        devs, ranks = mesh.grid(axis)
        rows_dev, rows_rank = devs[None], ranks[None]
    else:
        rows_dev, rows_rank = mesh.grid(batch_axis, axis)
    me = process_rank()
    # one set of segment lowerings per row of entries, each segment's
    # state on its entry's device
    lows = {r: [lower(s, width=w, device=d)
                for s, w, d in zip(segs, widths, rows_dev[r])]
            for r in range(rows_dev.shape[0])
            if int(rows_rank[r][0]) == me}
    if not lows:
        raise ValueError(f"no row of mesh axis {batch_axis!r} lies in "
                         f"process {me}")
    take, emit = lows[min(lows)][0].take, lows[min(lows)][-1].emit
    perm = [(k, k + 1) for k in range(K - 1)]

    def pipeline(row, xs):
        """One stream through row `row`'s entries: xs (M, take, ...) ->
        (M emitted chunks, exit carries per segment)."""
        los, devs = lows[row], rows_dev[row]
        m_real = xs.shape[0]
        if tuple(xs.shape[2:]) != item_shape:
            raise LowerError(
                f"input items of shape {tuple(xs.shape[2:])} where the "
                f"pipeline was lowered for {item_shape}")
        carries = [lo.init_carry for lo in los]
        slots = [None] * K
        ys = []
        for m in range(m_real + K - 1):
            outs = [None] * K
            for k in range(K):
                if not k <= m < m_real + k:
                    continue            # fill / drain bubble
                x = E._t(xs[m], devs[k]) if k == 0 else slots[k]
                carries[k], outs[k] = los[k].step(carries[k], x)
            if outs[K - 1] is not None:
                ys.append(outs[K - 1])
            slots = ppermute(outs, perm, devs)
        # read back once every step is queued, not once a step
        return np.stack([_host(y) for y in ys]), carries

    def _call(xs):
        if isinstance(xs, (list, tuple)):     # shard_batch's parts
            xs = np.concatenate([_host(p) for p in xs])
        xs = _host(xs)
        with exact_fp32(), torch.no_grad():
            if batch_axis is None:
                return pipeline(0, xs)
            n_rows = rows_dev.shape[0]
            if xs.shape[0] % n_rows:
                raise ValueError(
                    f"{xs.shape[0]} streams do not divide over the "
                    f"{n_rows} entries of mesh axis {batch_axis!r}")
            per = xs.shape[0] // n_rows
            local = {}
            for r in lows:
                local[r] = [pipeline(r, xs[b])
                            for b in range(r * per, (r + 1) * per)]
            if mesh.spans_processes():
                local = {r: [(y, [_to_host_tree(c) for c in cs])
                             for y, cs in v] for r, v in local.items()}
            got = list(chain.from_iterable(
                allgather_parts(local, n_rows, mesh)))
            return (np.stack([y for y, _c in got]), [c for _y, c in got])

    def run(xs):
        return _call(xs)[0]

    def run_carry(xs):
        """(ys, carry): a run_jit_carry carry dict whose "stages" follow
        lower(pipe(*segments))'s stage order; with batch_axis a list of
        such dicts, one per stream (row of xs)."""
        ys, carries = _call(xs)
        if batch_axis is None:
            return ys, {"stages": tuple(chain.from_iterable(carries))}
        return ys, [{"stages": tuple(chain.from_iterable(c))}
                    for c in carries]

    return PPLowered(run=run, run_carry=run_carry, take=take, emit=emit,
                     n_stages=K, labels=tuple(s.label() for s in segs))


def _to_host_tree(v):
    """A carry with its tensors on the host, for the trip between
    processes."""
    if isinstance(v, tuple):
        return tuple(_to_host_tree(x) for x in v)
    if isinstance(v, list):
        return [_to_host_tree(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_host_tree(x) for k, x in v.items()}
    return v.detach().cpu() if isinstance(v, torch.Tensor) else v
