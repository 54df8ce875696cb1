"""Cardinality analysis: static take/emit multiplicities (port copy of
ziria_tpu/core/card.py, which imports no JAX).

Counterpart of the reference's cardinality pass (SURVEY.md §2.1,
`CardAnalysis.hs` — the prerequisite for its vectorizer). Re-designed as a
synchronous-dataflow (SDF) rate analysis, because that is the form the TPU
backend consumes: a transformer with rate ``i -> o`` firing ``r`` times per
steady-state iteration becomes a reshape to ``(r, i, ...)`` plus a
``vmap``/``scan`` at lowering time.

Results:

- computers get a total ``CCard(take, emit)`` over their whole run;
- transformers get a per-firing ``TCard(i, o)`` rate;
- anything data-dependent is ``DYN`` (interpreter-only, or handled by
  frame-level patterns in phy/).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd
from typing import Optional, Union

from ziria_tpu_torch.core import ir


@dataclass(frozen=True)
class CCard:
    """Computer cardinality: total items taken/emitted before termination."""

    take: int
    emit: int


@dataclass(frozen=True)
class TCard:
    """Transformer cardinality: items taken/emitted per firing."""

    i: int
    o: int


@dataclass(frozen=True)
class Dyn:
    """Unknown / data-dependent cardinality."""


DYN = Dyn()
Card = Union[CCard, TCard, Dyn]


def _lcm(a: int, b: int) -> int:
    return a * b // gcd(a, b)


def cardinality(comp: ir.Comp) -> Card:
    """Compute the cardinality of `comp`. Never raises on dynamic
    structure — returns DYN instead, mirroring how the reference's
    vectorizer simply skips segments without static cardinalities."""
    if isinstance(comp, ir.Take):
        return CCard(1, 0)
    if isinstance(comp, ir.Takes):
        return CCard(comp.n, 0)
    if isinstance(comp, ir.Emit):
        return CCard(0, 1)
    if isinstance(comp, ir.Emits):
        return CCard(0, comp.n)
    if isinstance(comp, (ir.Return, ir.Assign)):
        return CCard(0, 0)
    if isinstance(comp, ir.Bind):
        a, b = cardinality(comp.first), cardinality(comp.rest)
        if isinstance(a, CCard) and isinstance(b, CCard):
            return CCard(a.take + b.take, a.emit + b.emit)
        return DYN
    if isinstance(comp, ir.LetRef):
        return cardinality(comp.body)
    if isinstance(comp, (ir.Map, ir.MapAccum, ir.JaxBlock)):
        return TCard(comp.in_arity, comp.out_arity)
    if isinstance(comp, ir.Repeat):
        b = cardinality(comp.body)
        if isinstance(b, CCard):
            if b.take == 0 and b.emit == 0:
                return DYN  # repeat of pure computer: no steady-state rate
            return TCard(b.take, b.emit)
        return DYN
    if isinstance(comp, ir.For):
        if not isinstance(comp.count, int):
            return DYN
        b = cardinality(comp.body)
        if isinstance(b, CCard):
            return CCard(b.take * comp.count, b.emit * comp.count)
        return DYN
    if isinstance(comp, ir.While):
        return DYN
    if isinstance(comp, ir.Branch):
        a, b = cardinality(comp.then), cardinality(comp.els)
        return a if a == b else DYN
    if isinstance(comp, (ir.Pipe, ir.ParPipe)):
        return _pipe_card(cardinality(comp.up), cardinality(comp.down))
    return DYN


def _pipe_card(a: Card, b: Card) -> Card:
    # transformer >>> transformer: steady-state SDF composition
    if isinstance(a, TCard) and isinstance(b, TCard):
        l = _lcm(a.o, b.i) if a.o and b.i else 0
        if l == 0:
            return DYN
        ra, rb = l // a.o, l // b.i
        return TCard(ra * a.i, rb * b.o)
    # computer upstream of a transformer: the composite is a computer that
    # terminates when the upstream does; totals only line up when upstream
    # emission count is a multiple of the transformer's input rate.
    if isinstance(a, CCard) and isinstance(b, TCard):
        if b.i and a.emit % b.i == 0:
            return CCard(a.take, (a.emit // b.i) * b.o)
        return DYN
    if isinstance(a, TCard) and isinstance(b, CCard):
        if a.o and b.take % a.o == 0:
            return CCard((b.take // a.o) * a.i, b.emit)
        return DYN
    return DYN


@dataclass(frozen=True)
class SteadyState:
    """Steady-state firing plan for a flattened transformer pipeline:
    stage k fires reps[k] times per iteration; the iteration consumes
    `take` input items and produces `emit` output items."""

    reps: tuple
    take: int
    emit: int


def steady_state(stages) -> Optional[SteadyState]:
    """Compute the SDF repetition vector for a list of transformer stages.

    Returns None if any stage lacks a static transformer rate. This plan is
    what the jit backend fuses into a single step function: the reference's
    vectorizer searched (in,out)-width scale factors per segment
    (SURVEY.md §2.1 `VecSF.hs`); here the widths fall out of the repetition
    vector and the planner's chosen outer batching factor.
    """
    stages = list(stages)
    if not stages:
        return None
    cards = [cardinality(s) for s in stages]
    if not all(isinstance(c, TCard) for c in cards):
        return None
    # A zero rate on an interior edge (a sink mid-chain, or a pure source
    # downstream of anything) has no steady state — not plannable.
    for k, c in enumerate(cards):
        if k < len(cards) - 1 and c.o == 0:
            return None
        if k > 0 and c.i == 0:
            return None
    reps = [1] * len(stages)
    for k in range(len(stages) - 1):
        prod = cards[k].o * reps[k]
        need = cards[k + 1].i
        l = _lcm(prod, need)
        scale_up = l // prod
        if scale_up != 1:
            for j in range(k + 1):
                reps[j] *= scale_up
            prod = l
        reps[k + 1] = prod // need
    return SteadyState(tuple(reps), reps[0] * cards[0].i,
                       reps[-1] * cards[-1].o)
