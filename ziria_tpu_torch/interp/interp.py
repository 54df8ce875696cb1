"""Streaming interpreter — the semantic oracle (counterpart of
ziria_tpu/interp/interp.py).

Executes the full IR item-at-a-time with numpy values, including all the
dynamic constructs the jit backend refuses (While, dynamic For counts,
value-dependent Branch, LetRef). Plays the role the reference's
compile-time interpreter / partial evaluator plays as a reference
semantics for testing (SURVEY.md §2.1 `Interpreter.hs`, §4): every fused
jit lowering must produce output equal (to tolerance) to this interpreter
on golden inputs.

Values are numpy on the host; a tensor (an array a device block left
on the card) flows through unchanged, and stacks of items that hold
one are built with torch (utils/txp).

Implementation: each component runs as a Python generator that *yields*
emitted items and *returns* its control value; `take` pulls from a
`source()` thunk. Upstream termination propagates as an `UpstreamDone`
exception carrying the terminating component's value, which gives exactly
the reference semantics for `>>>`: the composite terminates, with the
value of whichever side terminated first.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.ir import Env, eval_expr


class UpstreamDone(Exception):
    """Raised by a `source()` when the upstream computer terminated (or
    input hit EOF); carries the terminating value. `token` identifies which
    Pipe's upstream terminated, so that exact Pipe node catches it (and
    terminates locally with the value — reference `>>>` semantics) while
    outer-input EOF propagates all the way out."""

    def __init__(self, value: Any = None, token: Any = None):
        super().__init__("upstream terminated")
        self.value = value
        self.token = token


class Source:
    """Pull-source with pushback: the handle every `take` in a stream
    level shares. Chunked state machines (backend/chunked.py) bulk-pull
    a window of items, let the compiled step consume what it can, and
    `push_back` the unconsumed tail — which MUST remain visible to
    whatever takes next in the same stream level, hence a shared object
    rather than a bare closure. The first `UpstreamDone` is LATCHED
    (value + token) and re-raised on every later pull once pushed-back
    items drain: a re-pull of an exhausted generator would raise a
    fresh StopIteration carrying None, silently dropping the upstream
    computer's return value the original exception carried."""

    __slots__ = ("_pull", "_back", "_pending")

    def __init__(self, pull: Callable[[], Any]):
        self._pull = pull
        self._back: List[Any] = []
        self._pending: Optional[UpstreamDone] = None

    def __call__(self):
        if self._back:
            return self._back.pop()
        if self._pending is not None:
            raise UpstreamDone(self._pending.value, self._pending.token)
        try:
            return self._pull()
        except UpstreamDone as e:
            self._pending = e
            raise

    def push_back(self, items) -> None:
        """Re-enqueue `items` so the FIRST of them is the next pulled."""
        self._back.extend(reversed(list(items)))

    def pending(self) -> int:
        """Items pulled from upstream but pushed back (not yet re-taken)."""
        return len(self._back)

    def pull_block(self, n: int):
        """Pull up to `n` items; returns (items, eof). `eof` means the
        underlying stream raised UpstreamDone before `n` items arrived
        (the exception is latched and re-raises, with its original
        value/token, on the next pull past the buffered items)."""
        items: List[Any] = []
        while len(items) < n and self._back:
            items.append(self._back.pop())
        if self._pending is not None:
            return items, True
        try:
            while len(items) < n:
                items.append(self._pull())
        except UpstreamDone as e:
            self._pending = e
            return items, True
        return items, False


def _xp_for(xp, items):
    """numpy stays the namespace unless an item is a tensor."""
    if xp is np and any(isinstance(x, torch.Tensor) for x in items):
        from ziria_tpu_torch.utils import txp
        return txp
    return xp


def _stack(xp, items):
    xp = _xp_for(xp, items)
    if xp is np:
        return np.stack([np.asarray(x) for x in items])
    return xp.stack(items)


def _run(comp: ir.Comp, env: Env, source: Callable[[], Any], xp=np):
    """Generator: yields emitted items; returns the control value."""
    rg = getattr(comp, "run_gen", None)
    if rg is not None:
        # extension nodes (backend/chunked._ChunkLoop) drive themselves
        return (yield from rg(env, source, xp))

    if isinstance(comp, ir.Take):
        return source()
        yield  # pragma: no cover — makes this a generator

    if isinstance(comp, ir.Takes):
        if isinstance(source, Source):
            items, _eof = source.pull_block(comp.n)
            if len(items) < comp.n:
                source()  # re-raises the underlying UpstreamDone
        else:
            items = [source() for _ in range(comp.n)]
        return _stack(xp, items)
        yield  # pragma: no cover

    if isinstance(comp, ir.Emit):
        yield eval_expr(comp.expr, env)
        return None

    if isinstance(comp, ir.Emits):
        v = eval_expr(comp.expr, env)
        arr = _xp_for(xp, [v]).asarray(v)
        if arr.ndim == 0 or arr.shape[0] != comp.n:
            raise ValueError(
                f"emits: declared n={comp.n} but expression has shape "
                f"{arr.shape}")
        for k in range(comp.n):
            yield arr[k]
        return None

    if isinstance(comp, ir.Return):
        return eval_expr(comp.expr, env)
        yield  # pragma: no cover

    if isinstance(comp, ir.Bind):
        v = yield from _run(comp.first, env, source, xp)
        if comp.var is not None:
            env = env.child()
            env.bind(comp.var, v)
        return (yield from _run(comp.rest, env, source, xp))

    if isinstance(comp, ir.LetRef):
        env = env.child()
        env.bind_ref(comp.var, eval_expr(comp.init, env))
        return (yield from _run(comp.body, env, source, xp))

    if isinstance(comp, ir.Assign):
        env.set(comp.var, eval_expr(comp.expr, env))
        return None
        yield  # pragma: no cover

    if isinstance(comp, (ir.Map, ir.MapAccum, ir.JaxBlock)):
        stateful = not isinstance(comp, ir.Map)
        state = comp.init_state() if stateful else None
        while True:
            if comp.in_arity == 1:
                x = source()
            else:
                x = _stack(xp, [source() for _ in range(comp.in_arity)])
            if stateful:
                state, y = comp.f(state, x)
            else:
                y = comp.f(x)
            if comp.out_arity == 1:
                yield y
            else:
                y = _xp_for(xp, [y]).asarray(y)
                for k in range(comp.out_arity):
                    yield y[k]

    if isinstance(comp, ir.Repeat):
        from ziria_tpu_torch.core.card import CCard, cardinality
        c = cardinality(comp.body)
        if isinstance(c, CCard) and c.take == 0 and c.emit == 0:
            raise ValueError(
                "repeat of a computation with no stream I/O diverges "
                f"(body {comp.body.label()} has cardinality (0, 0))")
        # Runtime guard for dynamically-pure bodies the static check can't
        # see (e.g. a For with dynamic count 0): an iteration that neither
        # takes nor emits would loop forever without ever yielding control.
        takes_seen = [0]

        def counting_pull():
            takes_seen[0] += 1
            return source()

        # one Source for the whole repeat: pushback from a chunked loop
        # in one iteration stays visible to the next iteration's takes
        body_source = Source(counting_pull)

        while True:
            # net consumption = pulls minus still-pushed-back items, so a
            # bulk-pull-then-push-back cycle doesn't fake progress
            before = takes_seen[0] - body_source.pending()
            emitted = False
            it = _run(comp.body, env, body_source, xp)
            try:
                while True:
                    item = next(it)
                    emitted = True
                    yield item
            except StopIteration:
                pass
            if not emitted and takes_seen[0] - body_source.pending() == before:
                raise ValueError(
                    "repeat body made no stream progress in an iteration "
                    f"(body {comp.body.label()}): diverges")

    if isinstance(comp, ir.For):
        n = int(eval_expr(comp.count, env))
        v = None
        for i in range(n):
            e = env
            if comp.var is not None:
                e = env.child()
                e.bind(comp.var, i)
            v = yield from _run(comp.body, e, source, xp)
        return v

    if isinstance(comp, ir.While):
        v = None
        while bool(eval_expr(comp.cond, env)):
            v = yield from _run(comp.body, env, source, xp)
        return v

    if isinstance(comp, ir.Branch):
        tgt = comp.then if bool(eval_expr(comp.cond, env)) else comp.els
        return (yield from _run(tgt, env, source, xp))

    if isinstance(comp, (ir.Pipe, ir.ParPipe)):
        # ParPipe is semantically identical to Pipe here (the reference's
        # |>>>| must produce output identical to >>>; SURVEY.md §4).
        up_gen = _run(comp.up, env, source, xp)
        token = object()  # identifies THIS pipe's upstream termination

        def down_pull():
            try:
                return next(up_gen)
            except StopIteration as e:
                raise UpstreamDone(e.value, token=token) from None

        down_source = Source(down_pull)

        # `>>>` terminates as soon as either side does, with that side's
        # value: downstream termination is a plain generator return;
        # upstream termination arrives as UpstreamDone tagged with our
        # token and is caught HERE (an enclosing Bind continues with the
        # value). Untagged/foreign UpstreamDone = outer input EOF or an
        # outer pipe's upstream — propagate.
        try:
            return (yield from _run(comp.down, env, down_source, xp))
        except UpstreamDone as e:
            if e.token is token:
                return e.value
            raise

    raise TypeError(f"interpreter: unknown IR node {type(comp).__name__}")


class Result:
    """Outcome of running a computation over a finite input."""

    def __init__(self, outputs: List[Any], value: Any, consumed: int,
                 terminated_by: str):
        self.outputs = outputs
        self.value = value
        self.consumed = consumed
        self.terminated_by = terminated_by  # "computer" | "eof" | "limit"

    def out_array(self) -> np.ndarray:
        if not self.outputs:
            return np.empty((0,))
        if any(isinstance(o, torch.Tensor) for o in self.outputs):
            # items left on the device come home in one copy
            from ziria_tpu_torch.utils import txp
            return txp.stack(self.outputs).cpu().numpy()
        return np.stack([np.asarray(o) for o in self.outputs])


def run(comp: ir.Comp, inputs: Iterable[Any] = (),
        max_out: Optional[int] = None, env: Optional[Env] = None) -> Result:
    """Run `comp` over `inputs` (any iterable of items).

    Stops when the computation terminates, input is exhausted while the
    computation takes (reference EOF semantics), or `max_out` outputs have
    been produced (needed for infinite transformers).
    """
    it = iter(inputs)
    consumed = [0]

    def pull():
        try:
            x = next(it)
        except StopIteration:
            raise UpstreamDone(None) from None
        consumed[0] += 1
        return x

    source = Source(pull)
    outputs: List[Any] = []
    gen = _run(comp, env or Env(), source)
    try:
        while True:
            if max_out is not None and len(outputs) >= max_out:
                return Result(outputs, None,
                              consumed[0] - source.pending(), "limit")
            outputs.append(next(gen))
    except StopIteration as e:
        return Result(outputs, e.value,
                      consumed[0] - source.pending(), "computer")
    except UpstreamDone as e:
        return Result(outputs, e.value,
                      consumed[0] - source.pending(), "eof")
