"""State localization: LetRef⁺(Repeat body) → MapAccum (counterpart
of ziria_tpu/core/localize.py).

The reference's C codegen moves every component-local `var` into the
global state struct its tick/process functions thread through
(SURVEY.md §2.1 CgMonad "global state struct"). The analogue here:
a stateful repeat written with mutable refs

    LetRef v1 ... LetRef vk (Repeat body)

becomes an explicit-state ``MapAccum`` whose carry is the tuple of ref
values — what the jit backend's sequential stage loop threads — so
parsed/handwritten stateful blocks reach the fused jit path instead of
being interpreter-only.

The firing function reuses the streaming interpreter with torch values
(exactly like backend/lower.firing_fn): the oracle and the compiler
share one semantics. It runs one firing at a time inside a device
block (backend/lower._apply_scan), so its control may be
data-dependent. Conditions for the rewrite:

- the body has static cardinality (take ≥ 1, emit ≥ 1);
- the ref initializers evaluate without any enclosing runtime
  environment (checked by just trying);
- the chain is not under an enclosing binder that could be captured by
  body closures (same conservative scoping rule as opt.py's R3).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.card import CCard, cardinality
from ziria_tpu_torch.core.ir import Env, eval_expr


def _try_localize(c: ir.Comp) -> Optional[ir.Comp]:
    names: List[str] = []
    inits: List[Any] = []
    node = c
    while isinstance(node, ir.LetRef):
        names.append(node.var)
        inits.append(node.init)
        node = node.body
    if not names or not isinstance(node, ir.Repeat):
        return None
    body = node.body
    card = cardinality(body)
    if not isinstance(card, CCard) or card.take < 1 or card.emit < 1:
        return None

    # initializers must be closed (no enclosing runtime env): evaluate in
    # an Env seeded only with earlier refs of this same chain
    try:
        env0 = Env()
        vals = []
        for n, e in zip(names, inits):
            v = eval_expr(e, env0)
            env0.bind_ref(n, v)
            vals.append(v)
    except Exception:
        return None

    from ziria_tpu_torch.frontend.eval import _np_ok
    from ziria_tpu_torch.interp.interp import _run
    from ziria_tpu_torch.utils import txp

    init_state = tuple(vals)
    n_take, n_emit = card.take, card.emit
    _names = tuple(names)

    def f(state, chunk, _body=body, _names=_names,
          _n_take=n_take, _n_emit=n_emit):
        env = Env()
        for n, v in zip(_names, state):
            env.bind_ref(n, v)
        idx = [0]

        def src():
            x = chunk if _n_take == 1 else chunk[idx[0]]
            idx[0] += 1
            return x

        # host state and items (the interpreter backend) stay numpy;
        # tensors (the jit backend's stage loop) stay on the device
        host = _np_ok(chunk, *state)
        xp = np if host else txp
        outs = []
        gen = _run(_body, env, src, xp=xp)
        try:
            while True:
                outs.append(next(gen))
        except StopIteration:
            pass
        new_state = tuple(env.lookup(n) for n in _names)
        if _n_emit == 1:
            return new_state, xp.asarray(outs[0])
        return new_state, (np.stack([np.asarray(o) for o in outs])
                           if host else txp.stack(outs))

    label = "state[" + ",".join(names) + "]"
    return ir.MapAccum(f, init_state, in_arity=n_take, out_arity=n_emit,
                       name=label)


def localize(comp: ir.Comp) -> ir.Comp:
    """Rewrite every unscoped LetRef⁺(Repeat) chain into a MapAccum."""

    def walk(c: ir.Comp, scoped: bool = False) -> ir.Comp:
        if not scoped and isinstance(c, ir.LetRef):
            r = _try_localize(c)
            if r is not None:
                return r
        return ir.map_children(c, lambda ch, binds: walk(ch, scoped or binds))

    return walk(comp)
