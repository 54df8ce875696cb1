"""Auto-pipelining: place an unannotated pipeline across devices
(counterpart of ziria_tpu/parallel/autosplit.py).

The reference's auto-pipelining pass splits the program at ``|>>>|``
into threads (SURVEY.md §2.1, §3.3), but the programmer writes the
``|>>>|``. This pass writes it: given K entries of a mesh axis, it cuts
the flattened stage list into K contiguous segments that balance an
estimated per-iteration cost, and hands the result to
``parallel/stages.py`` (one segment an entry).

Cost model: items moved per steady-state iteration, ``reps * (in_arity
+ out_arity)``, a bandwidth proxy that weights rate-expanding stages
right without operation counts. Measured stage times
(:func:`measured_stage_costs`, ``--pp-costs=measured``) or a caller's
``cost_fn`` replace it; the partition does not depend on the model.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.card import CCard, TCard, cardinality, steady_state


class AutoSplitError(ValueError):
    pass


def _flatten(comp: ir.Comp) -> List[ir.Comp]:
    """Decompose >>> and |>>>| into the leaf stage list, to a fixpoint:
    a ParPipe nested under a Pipe never survives as one opaque stage."""
    if isinstance(comp, (ir.Pipe, ir.ParPipe)):
        return _flatten(comp.up) + _flatten(comp.down)
    return [comp]


def default_stage_cost(stage: ir.Comp, reps: int) -> float:
    """Items moved per steady-state iteration. Rates come from the
    cardinality analysis (a ``repeat { takes 64; emit .. }`` moves 65
    items a firing), else from the arity fields."""
    c = cardinality(stage)
    if isinstance(c, TCard):
        i, o = c.i, c.o
    elif isinstance(c, CCard):
        i, o = c.take, c.emit
    else:
        i = getattr(stage, "in_arity", 1) or 1
        o = getattr(stage, "out_arity", 1) or 1
    return float(reps * (max(i, 1) + max(o, 1)))


def balanced_partition(costs: Sequence[float], k: int) -> List[int]:
    """Split `costs` into k contiguous groups minimizing the largest
    group sum; returns the k-1 cut indices (group j = costs[cut[j-1]:
    cut[j]]). The O(n^2 k) dynamic program: stage lists are short."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    inf = float("inf")
    # best[j][m]: the least max-cost of the first j stages in m groups
    best = [[inf] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for m in range(1, k + 1):
        for j in range(m, n - (k - m) + 1):
            for i in range(m - 1, j):
                v = max(best[i][m - 1], prefix[j] - prefix[i])
                if v < best[j][m]:
                    best[j][m] = v
                    cut[j][m] = i
    cuts = []
    j, m = n, k
    while m > 1:
        i = cut[j][m]
        cuts.append(i)
        j, m = i, m - 1
    cuts.reverse()
    return cuts


def stage_runner(st: ir.Comp, cur, width: Optional[int] = None,
                 device="cuda"):
    """A zero-argument call running one stage over `cur` and returning
    its output (numpy), already run once: the jit backend when the
    stage lowers, else the hybrid executor, hybridized once so the
    first call warms what the later ones reuse. Its ``backend``
    attribute names which ran. The one stage-timing discipline of
    ``--profile`` and of :func:`measured_stage_costs`.

    The port's jit lowering finds control that depends on the data when
    it first runs, so the first call decides between the two."""
    from ziria_tpu_torch.backend.execute import run_jit_carry
    from ziria_tpu_torch.backend.lower import LowerError, lower

    def jit():
        return np.asarray(run_jit_carry(st, cur, width=width,
                                        device=device)[0])
    try:
        lower(st, width=width, device=device)
        jit()
        jit.backend = "jit"
        return jit
    except LowerError:
        import torch

        from ziria_tpu_torch.backend.hybrid import hybridize
        from ziria_tpu_torch.interp.interp import run
        hyb = hybridize(st, device=device)

        def hybrid():
            ys = run(hyb, list(cur)).out_array()
            return ys.detach().cpu().numpy() \
                if isinstance(ys, torch.Tensor) else np.asarray(ys)
        hybrid()
        hybrid.backend = "hybrid"
        return hybrid


def measured_stage_costs(flat: Sequence[ir.Comp], sample,
                         width: Optional[int] = None, reps: int = 3,
                         device="cuda") -> List[float]:
    """The wall time of each leaf stage on a sample of the real input,
    each stage's output feeding the next: the stage runner's first run
    absorbs the warm-up, then the least of `reps` timed runs (the least
    drops the scheduler's spikes, which on a loaded host misrank stages
    of one rate). On the card each timed run ends in a synchronize."""
    import time

    import torch

    on_card = torch.device(device).type == "cuda"
    costs: List[float] = []
    cur = np.asarray(sample)
    for st in flat:
        if cur.shape[0] == 0:
            # an empty cascade would time every later stage on nothing
            raise AutoSplitError(
                f"measured costs need a non-empty sample at every "
                f"stage; stage {st.label()} received 0 items (sample "
                f"too short for the upstream take rates?)")
        go = stage_runner(st, cur, width=width, device=device)
        best = float("inf")
        out = None
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            out = go()
            if on_card:
                torch.cuda.synchronize(device)
            best = min(best, time.perf_counter() - t0)
        costs.append(max(best, 1e-9))
        cur = out
    return costs


def auto_pipeline(comp: ir.Comp, n_segments: int,
                  cost_fn: Optional[Callable] = None, sample=None,
                  width: Optional[int] = None, device="cuda") -> ir.Comp:
    """Rewrite `comp` (a static-rate ``>>>`` pipeline) into `n_segments`
    ParPipe segments of balanced estimated cost. Existing ParPipe
    annotations are flattened and decided again. Costs come from (first
    that applies) `sample`, the measured stage times over that input on
    `device`; `cost_fn(stage, reps)`; the items-moved proxy."""
    flat = _flatten(comp)
    if n_segments < 1:
        raise AutoSplitError("need at least one segment")
    if n_segments > len(flat):
        raise AutoSplitError(
            f"cannot split {len(flat)} stage(s) into {n_segments} "
            f"segments; reduce the axis or widen the program")
    ss = steady_state(flat)
    if ss is None:
        raise AutoSplitError(
            "auto-pipelining needs a static steady state; dynamic "
            "pipelines run on the hybrid executor instead")
    if sample is not None:
        costs = measured_stage_costs(flat, sample, width=width,
                                     device=device)
    else:
        fn = cost_fn or default_stage_cost
        costs = [fn(s, r) for s, r in zip(flat, ss.reps)]
    cuts = [0] + balanced_partition(costs, n_segments) + [len(flat)]
    groups = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        g = flat[a]
        for s in flat[a + 1:b]:
            g = ir.Pipe(g, s)
        groups.append(g)
    return ir.par_pipe(*groups)
