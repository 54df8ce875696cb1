"""Vectorizer: scale-factor search, utility model, widening, mitigators
(counterpart of ziria_tpu/core/vectorize.py).

The reference compiler's headline optimization (SURVEY.md §2.1:
`Vectorize.hs` / `VecM.hs` / `VecSF.hs`) searches per-component scale
factors scored by a utility function, rewrites `take -> takes` /
`emit -> emits`, and inserts reshaping "mitigators" between mismatched
widths. Here, as in the reference:

- the SDF steady state (core/card.py) ties the per-stage firing counts
  together, so the free scale factor is ``W``, the steady-state
  iterations one fused step processes; widths are ``reps[k] * W``;
- the utility model scores W against the device's cost structure: the
  per-step overhead amortized over the items a step moves, a stateless
  stage's firings running as one batched call (flat cost until
  ``vpu_parallel`` parallel firings, then linear), a stateful stage's
  firings running in order (linear), and a cap on the live chunk;
- widening is planning (pass ``W`` to ``backend.lower``) or an explicit
  rewrite (``widen``, with ``mitigator`` between stages of different
  widths);
- pipelines with dynamic-rate stages are split into maximal static
  segments; ``backend.execute.run_vect`` runs the static ones on the
  jit backend at their widths and the dynamic ones on the hybrid
  backend.

The model's two constants are the card's own: ``MODEL_CONSTANTS`` is
read from ``vect_calib.json`` beside this module, whose ``"cuda"`` row
``scripts/calibrate_vect.py`` fits on the card and whose ``"cpu"`` row
it fits on the CPU under torch; each row's ``pedigree`` says where it
was measured. ``active_platform(device)`` picks the row of the device a
run uses.

`VectPlan.dump()` is the ``--ddump-vect`` output: the scored candidate
table per segment.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from math import gcd
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.card import SteadyState, TCard, cardinality, \
    steady_state

#: the live-chunk cap of a candidate width (bytes): a third of the
#: H100's 50 MB L2 cache, so a step's largest inter-stage chunk stays
#: cache-resident
DEFAULT_CHUNK_BUDGET = 16 << 20

#: the fitted constants, one row per platform
CALIB_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "vect_calib.json")


def _load_constants() -> Dict[str, dict]:
    with open(CALIB_FILE) as f:
        rows = json.load(f)["platforms"]
    return {k: {"vpu_parallel": float(r["vpu_parallel"]),
                "step_overhead": float(r["step_overhead"]),
                "pedigree": r["pedigree"]} for k, r in rows.items()}


#: {"cuda": {...}, "cpu": {...}}: vpu_parallel (parallel firings one
#: sequential firing costs as much as), step_overhead (a step's fixed
#: cost in sequential-firing units) and pedigree
MODEL_CONSTANTS = _load_constants()


def active_platform(device="cuda") -> str:
    """The row of the device a run uses: "cuda" or "cpu"."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def model_constants(platform: Optional[str] = None,
                    device="cuda") -> dict:
    """{vpu_parallel, step_overhead, pedigree} of `platform` (default:
    the row of `device`)."""
    return dict(MODEL_CONSTANTS[platform or active_platform(device)])


_STATEFUL = (ir.MapAccum, ir.JaxBlock)


def _lcm(a: int, b: int) -> int:
    return a * b // gcd(a, b)

# --------------------------------------------------------------------------
# Utility model (the VecSF scoring analogue)
# --------------------------------------------------------------------------


def utility(ss: SteadyState, stages: Sequence[ir.Comp], W: int,
            item_bytes: int = 4,
            chunk_budget: int = DEFAULT_CHUNK_BUDGET,
            constants: Optional[dict] = None,
            device="cuda") -> Tuple[float, str]:
    """Score scale factor W for one static segment; returns (utility, note).

    utility = items_per_step / time_proxy, where

    - items_per_step = ss.take * W (amortizes step_overhead);
    - each stateless stage contributes max(F/vpu_parallel, 1) — its F
      firings run as one batched call, so cost is flat until the
      device's parallel lanes fill, then linear;
    - each stateful stage contributes F — its firings run in order, so
      widening adds latency without parallelism (it still helps by
      amortizing the per-step overhead, which the model captures);
    - candidates whose largest live chunk exceeds chunk_budget are
      infeasible (utility -inf, note says why). Chunk size is estimated
      as the max over inter-stage edges of items-on-edge * item_bytes.

    The note string goes into the --ddump-vect style dump. Without
    `constants` the model is `device`'s row (model_constants).
    """
    cards = [cardinality(s) for s in stages]
    # largest inter-stage edge, in items per step
    edge_items = [ss.take * W]
    run = ss.take * W
    for c, r in zip(cards, ss.reps):
        assert isinstance(c, TCard)
        run = c.o * r * W
        edge_items.append(run)
    max_edge = max(edge_items)
    bytes_live = max_edge * item_bytes
    if bytes_live > chunk_budget:
        return float("-inf"), (
            f"infeasible: live chunk {bytes_live}B > chunk budget "
            f"{chunk_budget}B")
    c = constants or model_constants(device=device)
    time_proxy = c["step_overhead"]
    for stage, r in zip(stages, ss.reps):
        F = r * W
        if isinstance(stage, _STATEFUL):
            time_proxy += float(F)
        else:
            time_proxy += max(float(F) / c["vpu_parallel"], 1.0)
    u = (ss.take * W) / time_proxy
    return u, f"chunk={max_edge} items ({bytes_live}B)"


def search_width(ss: SteadyState, stages: Sequence[ir.Comp],
                 item_bytes: int = 4,
                 chunk_budget: int = DEFAULT_CHUNK_BUDGET,
                 max_width: int = 1 << 20,
                 constants: Optional[dict] = None,
                 device="cuda"):
    """Enumerate candidate scale factors (powers of two) and score them.

    Returns (best_W, candidates) with candidates a list of
    (W, utility, note). Tie-break: the SMALLEST W within 1% of the best
    utility wins — beyond the amortization knee extra width only adds
    latency and memory (the reference's utility similarly penalized
    overly wide rewrites). Without `constants` the model is `device`'s
    row (model_constants).
    """
    constants = constants or model_constants(device=device)
    cands: List[Tuple[int, float, str]] = []
    W = 1
    while W <= max_width:
        u, note = utility(ss, stages, W, item_bytes, chunk_budget,
                          constants)
        cands.append((W, u, note))
        if u == float("-inf"):
            break  # wider only grows the chunk further
        W *= 2
    best_u = max(u for _, u, _ in cands)
    if best_u == float("-inf"):
        # even W=1 blows the chunk budget: fall back to width 1 but say so
        # in the dump rather than presenting it as a model choice
        cands.append((1, 0.0, "fallback: every candidate infeasible; "
                              "running at width 1 anyway"))
        return 1, cands
    best_W = 1
    for W, u, _ in cands:
        if u != float("-inf") and u >= 0.99 * best_u:
            best_W = W
            break
    return best_W, cands


# --------------------------------------------------------------------------
# Segmentation: maximal static runs, dynamic stages bridged
# --------------------------------------------------------------------------


@dataclass
class Segment:
    """A maximal run of consecutive pipeline stages. ``ss`` is the SDF
    steady state for static (jit-fusable) segments, None for dynamic
    segments (single stage, run on the hybrid backend)."""

    stages: Tuple[ir.Comp, ...]
    start: int
    ss: Optional[SteadyState]
    width: int = 1
    candidates: Tuple[Tuple[int, float, str], ...] = ()

    @property
    def dynamic(self) -> bool:
        return self.ss is None

    @property
    def comp(self) -> ir.Comp:
        return ir.pipe(*self.stages)


@dataclass
class VectPlan:
    """The vectorizer's output: segments with chosen widths."""

    segments: List[Segment] = field(default_factory=list)
    constants: dict = field(default_factory=dict)

    def dump(self) -> str:
        """--ddump-vect analogue: scored candidate table per segment."""
        lines = []
        if self.constants:
            lines.append(
                f"model constants: vpu_parallel="
                f"{self.constants['vpu_parallel']:g} step_overhead="
                f"{self.constants['step_overhead']:g} "
                f"[{self.constants['pedigree']}]")
        for i, seg in enumerate(self.segments):
            labels = " >>> ".join(s.label() for s in seg.stages)
            if seg.dynamic:
                lines.append(f"segment {i}: DYNAMIC [{labels}] -> "
                             f"interpreter (no static cardinality)")
                continue
            lines.append(
                f"segment {i}: [{labels}] reps={seg.ss.reps} "
                f"take={seg.ss.take} emit={seg.ss.emit} -> width {seg.width}")
            for W, u, note in seg.candidates:
                mark = "*" if W == seg.width else " "
                u_s = "-inf" if u == float("-inf") else f"{u:.4f}"
                lines.append(f"  {mark} W={W:<8d} utility={u_s:<10s} {note}")
        return "\n".join(lines)


def _split_static_runs(stages: Sequence[ir.Comp]):
    """Group stages into maximal runs with a combined static steady state.

    Greedy: extend the current run while ``steady_state`` of the run
    stays defined; a stage that breaks it (dynamic cardinality, or a
    rate mismatch with the run) closes the run. Dynamic single stages
    become their own segments.
    """
    runs: List[Tuple[int, List[ir.Comp], Optional[SteadyState]]] = []
    cur: List[ir.Comp] = []
    cur_start = 0
    cur_ss: Optional[SteadyState] = None
    for k, s in enumerate(stages):
        trial = steady_state(cur + [s])
        if trial is not None:
            if not cur:
                cur_start = k
            cur.append(s)
            cur_ss = trial
            continue
        if cur:
            runs.append((cur_start, cur, cur_ss))
            cur, cur_ss = [], None
        solo = steady_state([s])
        if solo is not None:
            cur, cur_start, cur_ss = [s], k, solo
        else:
            runs.append((k, [s], None))
    if cur:
        runs.append((cur_start, cur, cur_ss))
    return runs


def vectorize(comp: ir.Comp, item_bytes: int = 4,
              chunk_budget: int = DEFAULT_CHUNK_BUDGET,
              max_width: int = 1 << 20, device="cuda",
              constants: Optional[dict] = None) -> VectPlan:
    """Plan vectorization for a pipeline on `device`: split into
    segments, search a scale factor for each static segment with the
    device's model constants (or `constants`). Pure planning — no IR
    rewrite; feed the plan to ``backend.execute.run_vect`` (or use a
    segment's ``width`` with ``backend.lower``)."""
    stages = ir.pipeline_stages(comp)
    plan = VectPlan()
    plan.constants = dict(constants) if constants else \
        model_constants(device=device)
    for start, run, ss in _split_static_runs(stages):
        if ss is None:
            plan.segments.append(Segment(tuple(run), start, None))
            continue
        W, cands = search_width(ss, run, item_bytes, chunk_budget,
                                max_width, plan.constants)
        plan.segments.append(
            Segment(tuple(run), start, ss, W, tuple(cands)))
    return plan


# --------------------------------------------------------------------------
# Widening rewrite (take -> takes analogue) + mitigators
# --------------------------------------------------------------------------


def _widen_stateless(f, a: int, b: int, w: int):
    """Widen a per-firing function (a items -> b items) by w: the widened
    function maps a blocks of w items to b blocks of w items, applying f
    to each of the w interleaved firings via torch.func.vmap. Block
    layout keeps raw stream order: block j element l is raw item j*w +
    l, so flattening a stacked (a, w, *item) input IS raw stream order."""
    def g(xs):
        xs = torch.as_tensor(xs)
        if a == 1:
            apps = xs  # (w, *item)
        else:
            flat = xs.reshape((a * w,) + xs.shape[2:])
            apps = flat.reshape((w, a) + flat.shape[1:])
        ys = torch.func.vmap(f)(apps)
        if b == 1:
            return ys
        flat_out = ys.reshape((w * b,) + ys.shape[2:])
        return flat_out.reshape((b, w) + flat_out.shape[1:])
    return g


def _widen_stateful(f, a: int, b: int, w: int):
    """Widen a stateful per-firing function: the w firings inside one
    widened firing run in order (state dependences are preserved
    exactly; the reference's lax.scan)."""
    def g(state, xs):
        xs = torch.as_tensor(xs)
        if a == 1:
            apps = xs
        else:
            flat = xs.reshape((a * w,) + xs.shape[2:])
            apps = flat.reshape((w, a) + flat.shape[1:])
        outs = []
        for k in range(w):
            state, y = f(state, apps[k])
            outs.append(torch.as_tensor(y))
        ys = torch.stack(outs)
        if b == 1:
            return state, ys
        flat_out = ys.reshape((w * b,) + ys.shape[2:])
        return state, flat_out.reshape((b, w) + flat_out.shape[1:])
    return g


def mitigator(w_in: int, w_out: int, name: Optional[str] = None) -> ir.Comp:
    """Reshape node between stages widened by different factors — the
    reference's mitigator (SURVEY.md §2.1). Takes lcm/w_in blocks of
    w_in items, emits lcm/w_out blocks of w_out items, identity on the
    underlying item stream."""
    L = _lcm(w_in, w_out)
    a, b = L // w_in, L // w_out

    def g(xs):
        xs = torch.as_tensor(xs)
        # normalize the input window to flat (L, *item) raw order;
        # width 1 means bare (unblocked) items on that side
        if w_in == 1:
            flat = xs if a > 1 else xs[None]
        elif a == 1:
            flat = xs  # one block of (w_in, *item) == (L, *item)
        else:
            flat = xs.reshape((L,) + xs.shape[2:])
        if w_out == 1:
            return flat if b > 1 else flat[0]
        if b == 1:
            return flat  # one block of (w_out, *item)
        return flat.reshape((b, w_out) + flat.shape[1:])

    return ir.Map(g, a, b, name or f"mitigate[{w_in}->{w_out}]")


def widen_stage(stage: ir.Comp, w: int) -> ir.Comp:
    """Rewrite one pipeline stage to operate on w-item blocks."""
    if w == 1:
        return stage
    if isinstance(stage, ir.Map):
        return ir.Map(_widen_stateless(stage.f, stage.in_arity,
                                             stage.out_arity, w),
                      stage.in_arity, stage.out_arity,
                      f"{stage.label()}^{w}")
    if isinstance(stage, (ir.MapAccum, ir.JaxBlock)):
        g = _widen_stateful(stage.f, stage.in_arity, stage.out_arity, w)
        if isinstance(stage, ir.MapAccum):
            adv = stage.advance
            if adv is not None:
                # one widened firing = w original firings
                def adv_w(s, n, _a=adv, _w=w):
                    return _a(s, n * _w)
            else:
                adv_w = None
            return ir.MapAccum(g, stage.init, stage.in_arity,
                               stage.out_arity, f"{stage.label()}^{w}",
                               advance=adv_w, memory=stage.memory)
        return ir.JaxBlock(g, stage.init, stage.in_arity, stage.out_arity,
                           f"{stage.label()}^{w}")
    if isinstance(stage, ir.Repeat):
        from ziria_tpu_torch.backend.lower import firing_fn
        fire, a, b = firing_fn(stage.body)
        return ir.Map(_widen_stateless(fire, a, b, w), a, b,
                      f"repeat({stage.body.label()})^{w}")
    raise ValueError(
        f"widen_stage: stage {stage.label()} ({type(stage).__name__}) has "
        f"no static widening; leave it at width 1")


def widen(comp: ir.Comp, w, insert_mitigators: bool = True) -> ir.Comp:
    """The take->takes / emit->emits rewrite: return a pipeline over
    w-item blocks. ``w`` is an int (uniform width) or a dict mapping
    stage index -> width; with per-stage widths, mitigators are inserted
    between mismatched neighbors (when ``insert_mitigators``).

    Feeding the widened pipeline: reshape the raw stream (N, *item) to
    (N/w, w, *item); flatten the output blocks back.
    """
    stages = ir.pipeline_stages(comp)
    if isinstance(w, int):
        widths = [w] * len(stages)
    else:
        widths = [w.get(k, 1) for k in range(len(stages))]
    out: List[ir.Comp] = []
    prev_w: Optional[int] = None
    for k, (s, wk) in enumerate(zip(stages, widths)):
        if prev_w is not None and prev_w != wk and insert_mitigators:
            out.append(mitigator(prev_w, wk))
        out.append(widen_stage(s, wk))
        prev_w = wk
    return ir.pipe(*out)
