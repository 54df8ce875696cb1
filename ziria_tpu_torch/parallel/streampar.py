"""Stream (sequence) parallelism: one long stream split across the
entries of a mesh axis (counterpart of ziria_tpu/parallel/streampar.py).

Two entry points:

- :func:`stream_parallel` runs a static-rate pipeline over one stream
  with its items split contiguously over an ``sp`` axis. Stateless
  stages shard freely: each entry runs the fused step of the jit
  backend (``backend/lower.py``) on its slice. Stateful stages join when
  their state evolves independently of the data and declares a
  closed-form fast-forward (``MapAccum.advance(state, n)``: LFSR
  scramblers, phase accumulators), each entry's state fast-forwarded to
  its offset; or when they have finite input memory
  (``MapAccum.memory=K``: FIR delay lines), each entry's state seeded
  by an exact warm-up over the items before its shard, gathered from
  its left neighbours (the warm-ups add up down the pipeline).
  Unbounded sequential state (a cumsum) is refused.

- :func:`sliding_parallel` is the halo exchange for windowed ops: each
  entry takes its shard plus the `window-1` items before it from its
  left neighbour (one ``ppermute``) and maps a plain function over
  them.

The shards run one after another in the calling process, each on its
entry's device; an sp axis never leaves the process.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ziria_tpu_torch.backend.lower import _to_device, lower
from ziria_tpu_torch.core import ir
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.ops.cplx import exact_fp32
from ziria_tpu_torch.parallel.mesh import (Mesh, allgather_parts,
                                           global_devices, ppermute,
                                           process_rank, shard)


class StreamParError(ValueError):
    """Pipeline not stream-parallelizable (stateful, or shapes that
    cannot align to the mesh)."""


_SP_LOCAL = ("the shards of one stream hand their edges to each other, "
             "which one process does between its own tensors")


def _leaves(c):
    if isinstance(c, (tuple, list)):
        for x in c:
            yield from _leaves(x)
    elif isinstance(c, dict):
        for k, x in c.items():
            if k != "__struct__":
                yield from _leaves(x)
    elif c is not None:
        yield c


def _carry_sig(c):
    """Shape and dtype of every leaf of a carry: the warm scan steps a
    width-1 lowering's carry into a wider one's, which holds only while
    the carry does not depend on the width."""
    def sig(x):
        t = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return tuple(t.shape), str(t.dtype)
    return [sig(x) for x in _leaves(c)]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _gather_warm_window(flats, devs, n_hops: int, warm_take: int):
    """For each entry, the last `warm_take` items of the stream before
    its shard, copied from its `n_hops` left neighbours: one
    ``ppermute`` a spanned shard, each sending only what the window
    needs (the furthest shard just its tail). An entry whose prefix is
    shorter than the window gets zero filler for the missing lead,
    which :func:`_masked_warm_scan` skips."""
    n_dev = len(flats)
    shard_items = flats[0].shape[0]
    got = []
    for hop in range(n_hops, 0, -1):
        send = flats
        if hop == n_hops:
            need = min(shard_items, warm_take - (n_hops - 1) * shard_items)
            send = [f[shard_items - need:] for f in flats]
        got.append(ppermute(send, [(i, i + hop) for i in range(n_dev - hop)],
                            devs))
    windows = []
    for d in range(n_dev):
        w = torch.cat([g[d] for g in got], dim=0)
        if w.shape[0] < warm_take:
            # the lead before the whole stream: masked for every entry
            pad = torch.zeros((warm_take - w.shape[0],) + tuple(w.shape[1:]),
                              dtype=w.dtype, device=w.device)
            w = torch.cat([pad, w], dim=0)
        windows.append(w)
    return windows


def _masked_warm_scan(small, carry, wchunks, first: int):
    """Step `small` over the warm window's chunks, leaving the carry as
    it is through the `first` leading chunks a short prefix does not
    have (0 where the window is whole)."""
    for i in range(first, wchunks.shape[0]):
        carry, _ = small.step(carry, wchunks[i])
    return carry


def stream_mesh(n_devices: Optional[int] = None, axis: str = "sp",
                device="cuda") -> Mesh:
    """A 1-D mesh over the first `n_devices` devices of `device`'s
    kind."""
    devs = global_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise StreamParError(
                f"need {n_devices} devices, only {len(devs)} visible")
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def _stage_plan(comp: ir.Comp, big):
    """Each carried stage's class for sharding: stateless (None), an
    `advance` fast-forward, or finite `memory` (adding to the warm-up).
    Memory warm-ups add up down the pipeline: a stage's inputs are right
    only once every memory stage above it has settled, so a max would
    feed it the upstream's cold-start outputs."""
    stages = ir.pipeline_stages(comp)
    advances = []
    warm_iters = 0
    for j, (s, c0) in enumerate(zip(stages, big.init_carry)):
        if not list(_leaves(c0)):
            advances.append(None)
            continue
        adv = getattr(s, "advance", None)
        mem = getattr(s, "memory", None)
        if adv is not None:
            advances.append(adv)
        elif mem is not None:
            if int(mem) != mem or int(mem) < 1:
                raise StreamParError(
                    f"stage {s.label()}: memory={mem!r} must be a "
                    f"positive integer (items of input history)")
            per_iter = big.ss.reps[j] * max(1, s.in_arity)
            warm_iters += -(-int(mem) // per_iter)
            advances.append(None)
        else:
            raise StreamParError(
                f"stage {s.label()} has loop-carried state and neither "
                f"an advance(state, n) fast-forward nor a finite "
                f"`memory` declaration; a sequential carry cannot "
                f"split across a stream — use frame batching "
                f"(parallel/batch.py) / stage pipelining "
                f"(parallel/stages.py)")
    return stages, advances, warm_iters


def _fast_forward_carry(stages, big, advances, n_iters: int, device):
    """Entry carries on `device` after `n_iters` iterations: the
    closed-form fast-forward of advance stages, the initial state of
    every other (memory stages get their warm-up from the caller)."""
    out = []
    for j, (s, c0, adv) in enumerate(zip(stages, big.init_carry, advances)):
        if adv is None:
            out.append(_to_device(c0, device))
        else:
            st = adv(s.init_state(), n_iters * big.ss.reps[j])
            out.append(_to_device(st, device))
    return tuple(out)


def _entry_carry_fn(comp, big, stages, advances, warm_iters: int):
    """carry_at(iters_done, items, device): the fast-forward plus, when
    a stage has finite memory, a warm-up scan over the `items` just
    before the shard (`items`: the stream the shard belongs to), its
    width-1 lowering made on `device` (once per device), as the
    reference lowers it on its default device."""
    smalls = {}

    def carry_at(iters_done: int, items, device):
        warm = min(warm_iters, iters_done)
        base = _fast_forward_carry(stages, big, advances, iters_done - warm,
                                   device)
        if not warm:
            return base
        device = torch.device(device)
        small = smalls.get(device)
        if small is None:
            small = smalls[device] = lower(comp, width=1, device=device)
        t1 = big.ss.take
        seg = items[(iters_done - warm) * t1: iters_done * t1]
        chunks = E._t(seg.reshape((warm, small.take) + items.shape[1:]),
                      device)
        carry, _ = small.scan_steps()(base, chunks)
        return carry

    return carry_at


def _plan(comp, n_items: int, n_shards: int, width, device):
    """The bulk lowering (re-planned at a shard's share when the planned
    width is wider), its stage plan and the shard geometry."""
    big = lower(comp, width=width, device=device)
    n_iters = n_items // big.ss.take
    share = n_iters // n_shards
    if 0 < share < big.width:
        big = lower(comp, width=share, device=device)
    stages, advances, warm_iters = _stage_plan(comp, big)
    per = share // big.width * big.width
    return big, n_iters, per, (stages, advances, warm_iters)


def _run_shards(comp, big, plan, items, per: int, devs, carry_at):
    """The aligned bulk of one stream (n_shards * per iterations) over
    the entries `devs`, each shard from its reconstructed entry carry.
    Memory warm-ups run on the entries: each gathers its warm window
    from its left neighbours and steps a width-1 lowering over it,
    unless the two lowerings' carries differ in shape (then `carry_at`,
    which copies each warm window from the host's stream to its entry
    and is right in any case). Returns the outputs (numpy)."""
    stages, advances, warm_iters = plan
    n_dev = len(devs)
    steps = per // big.width
    bulk = items[: n_dev * per * big.ss.take].reshape(
        (n_dev, steps, big.take) + items.shape[1:])
    parts = [E._t(bulk[d], devs[d]) for d in range(n_dev)]
    device_warm = warm_iters > 0 and n_dev > 1
    if device_warm:
        small = lower(comp, width=1, device=devs[0])
        device_warm = _carry_sig(small.init_carry) == \
            _carry_sig(big.init_carry)
    if device_warm:
        warm_take = warm_iters * small.take
        shard_items = per * big.ss.take
        n_hops = min(n_dev - 1, -(-warm_take // shard_items))
        flats = [p.reshape((steps * big.take,) + tuple(p.shape[2:]))
                 for p in parts]
        windows = _gather_warm_window(flats, devs, n_hops, warm_take)
        carries = []
        for d in range(n_dev):
            c = _fast_forward_carry(stages, big, advances,
                                    max(0, d * per - warm_iters), devs[d])
            w = windows[d].reshape((warm_iters, small.take)
                                   + tuple(windows[d].shape[1:]))
            carries.append(_masked_warm_scan(
                small, c, w, max(warm_iters - d * per, 0)))
    else:
        carries = [carry_at(d * per, items, devs[d]) for d in range(n_dev)]
    scan = big.scan_steps()
    ys = [_host(scan(carries[d], parts[d])[1]) for d in range(n_dev)]
    return np.concatenate([y.reshape((steps * big.emit,) + y.shape[2:])
                           for y in ys], axis=0)


def stream_parallel(comp: ir.Comp, inputs, mesh: Mesh,
                    axis: str = "sp", width: Optional[int] = None):
    """Run pipeline `comp` over `inputs` (one stream, leading axis =
    items) with the stream split contiguously over `mesh`'s `axis`;
    returns the whole output stream (numpy), equal to ``run_jit`` on
    any length.

    Stages must be stateless, or stateful with a declared fast-forward
    (``MapAccum.advance(state, n)``) or finite input memory
    (``MapAccum.memory=K``). Iterations that do not divide evenly, and
    the sub-iteration tail, run on the axis's first entry from the
    reconstructed state."""
    from ziria_tpu_torch.backend.execute import run_jit, run_jit_carry

    mesh.require_this_process(_SP_LOCAL)
    devs, _ranks = mesh.along(axis)
    home = devs[0]
    inputs = np.asarray(inputs)
    big, n_iters, per, plan = _plan(comp, inputs.shape[0], len(devs),
                                    width, home)
    if n_iters == 0:
        # below one steady-state iteration: the single-device run's
        # empty-output conventions
        return run_jit(comp, inputs, width=1, device=home)
    stateful = any(list(_leaves(c0)) for c0 in big.init_carry)
    carry_at = _entry_carry_fn(comp, big, *plan)
    outs = []
    done_iters = 0
    with exact_fp32(), torch.no_grad():
        if per:
            outs.append(_run_shards(comp, big, plan, inputs, per, devs,
                                    carry_at))
            done_iters = len(devs) * per
    if done_iters < n_iters:                  # the rest on one device
        rem = inputs[done_iters * big.ss.take: n_iters * big.ss.take]
        with exact_fp32(), torch.no_grad():
            tail_carry = carry_at(done_iters, inputs, home) \
                if stateful else None
        tail, _ = run_jit_carry(comp, rem, carry=tail_carry, width=width,
                                device=home)
        outs.append(np.asarray(tail))
    return np.concatenate(outs, axis=0)


def stream_parallel_batched(comp: ir.Comp, batch, mesh: Mesh,
                            dp_axis: str = "dp", sp_axis: str = "sp",
                            width: Optional[int] = None):
    """A batch of independent streams (leading axis = frames) split over
    `dp_axis`, each stream's items split over `sp_axis`: frame batching
    times sequence parallelism on one 2-D mesh.

    The stage rules are :func:`stream_parallel`'s, a memory stage's
    warm-up taken from each frame's own items. Frames must divide over
    dp; a frame's length need not divide over sp x width: the aligned
    bulk runs on the mesh and the rest of each frame on one device from
    its reconstructed state. Items past the last whole steady-state
    iteration are not consumed. The dp axis may span processes (each
    runs its rows); the sp axis may not."""
    from ziria_tpu_torch.backend.execute import run_jit_carry

    mesh.require_local(sp_axis, _SP_LOCAL)
    grid, ranks = mesh.grid(dp_axis, sp_axis)
    n_dp, n_sp = grid.shape
    batch = np.asarray(batch)
    if batch.ndim < 2:
        raise StreamParError("batch needs (frames, items, ...)")
    B, N = batch.shape[0], batch.shape[1]
    if B % n_dp:
        raise StreamParError(f"{B} frames do not divide over "
                             f"{n_dp} dp devices")
    me = process_rank()
    rows = [r for r in range(n_dp) if int(ranks[r][0]) == me]
    if not rows:
        raise StreamParError(f"no row of mesh axis {dp_axis!r} lies in "
                             f"process {me}")
    home = grid[rows[0]][0]
    big, n_iters, per, plan = _plan(comp, N, n_sp, width, home)
    if n_iters == 0:
        raise StreamParError(
            f"{N} items are fewer than one steady-state take "
            f"({big.ss.take})")
    stateful = any(list(_leaves(c0)) for c0 in big.init_carry)
    carry_at = _entry_carry_fn(comp, big, *plan)
    done_iters = n_sp * per
    lf = B // n_dp
    local = {}
    for r in rows:
        devs = list(grid[r])
        outs = []
        for f in range(r * lf, (r + 1) * lf):
            parts = []
            with exact_fp32(), torch.no_grad():
                if per:
                    parts.append(_run_shards(comp, big, plan, batch[f], per,
                                             devs, carry_at))
                tail_carry = carry_at(done_iters, batch[f], devs[0]) \
                    if stateful and done_iters < n_iters else None
            if done_iters < n_iters:
                # past the sp x width-aligned bulk (or all of a frame too
                # short to shard): one device, from the bulk's end state
                rem = batch[f, done_iters * big.ss.take:
                            n_iters * big.ss.take]
                t, _ = run_jit_carry(comp, rem, carry=tail_carry,
                                     width=width, device=devs[0])
                parts.append(np.asarray(t))
            outs.append(np.concatenate(parts, axis=0))
        local[r] = outs
    got = allgather_parts(local, n_dp, mesh)
    return np.stack([o for row in got for o in row])


def sliding_parallel(fn: Callable, xs, window: int, mesh: Mesh,
                     axis: str = "sp"):
    """Apply windowed `fn` to one long stream split over `mesh`'s
    `axis`.

    `fn(block) -> outs` maps a contiguous block of M items (a tensor on
    the entry's device) to its M - window + 1 full-window results. Each
    entry computes over its shard plus the window-1 items before it,
    copied from its left neighbour (entry 0 gets zeros, whose windows
    are dropped). Returns the N - window + 1 results of the whole
    stream (numpy). The stream length must divide over the axis, and a
    shard must hold at least window-1 items."""
    if window < 1:
        raise StreamParError("window must be >= 1")
    mesh.require_this_process(_SP_LOCAL)
    devs, _ranks = mesh.along(axis)
    n_dev = len(devs)
    xs = xs if isinstance(xs, torch.Tensor) else E._t(np.asarray(xs), "cpu")
    n = xs.shape[0]
    if n % n_dev:
        raise StreamParError(
            f"stream length {n} does not divide over {n_dev} devices; "
            f"pad to a multiple first")
    per = n // n_dev
    halo = window - 1
    if halo and per < halo:
        raise StreamParError(
            f"shards of {per} items are smaller than the "
            f"window-1 = {halo} halo")
    parts = shard(xs, mesh, axis)
    if halo:
        recv = ppermute([p[-halo:] for p in parts],
                        [(i, i + 1) for i in range(n_dev - 1)], devs)
        blocks = [torch.cat([recv[d], parts[d]], dim=0)
                  for d in range(n_dev)]
    else:
        blocks = parts
    ys = []
    with exact_fp32(), torch.no_grad():
        for block in blocks:
            outs = fn(block)
            if outs.shape[0] != per:
                raise StreamParError(
                    f"fn returned {outs.shape[0]} results for a "
                    f"{block.shape[0]}-item block; expected "
                    f"block - window + 1 = {per}")
            ys.append(_host(outs))
    ys = np.concatenate(ys, axis=0)
    # entry 0's first `halo` outputs looked into the zero filler: the
    # stream's full windows start at item 0
    return ys[halo:] if halo else ys
