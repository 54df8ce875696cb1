"""AutoLUT: compile small-domain pure maps into lookup tables
(counterpart of ziria_tpu/core/autolut.py).

Counterpart of the reference's AutoLUT pass (SURVEY.md §2.1,
`AutoLUT.hs`/`LUTAnalysis.hs`/`CgLUT.hs`): it analyzes pure expression
functions whose inputs have small bit-width and synthesizes compile-time
lookup tables. The "analysis" is a *declared* domain
(`zmap(f, in_domain=256)`, the role the reference's `int8`-style types
play) or an inferred packed-bits adapter (frontend/lutinfer.MapLut),
and "table synthesis" is one ``torch.func.vmap`` evaluation of `f` over
``arange(domain)`` at pass time; the rewritten map is a gather
``table[x]`` that vectorizes across the batch axis.

When a LUT map sits next to other maps, the fold pass's map-map fusion
(core/opt.py) composes the gather with its neighbors, so
``autolut(fold(p))`` or ``fold(autolut(p))`` both end in fused stages.
Tables are built on the CPU (lutinfer's tables are single tensors, never
struct rows); a gather of tensors on another device uses a copy of the
table there, made once per device.
"""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.core import ir


class LutError(ValueError):
    pass


MAX_TABLE_ITEMS = 1 << 22  # refuse absurd tables (16 MB of f32)


def build_table(m: ir.Map):
    """Evaluate m.f over its whole declared domain in one batched
    evaluation, on the CPU: (domain, *out_item)."""
    from ziria_tpu_torch.frontend import eval as E
    from ziria_tpu_torch.utils import txp

    if m.in_domain is None:
        raise LutError(f"map {m.label()} has no declared in_domain")
    if m.in_arity != 1:
        raise LutError(
            f"map {m.label()}: AutoLUT needs scalar input items "
            f"(in_arity == 1); got in_arity={m.in_arity}")
    dom = int(m.in_domain)
    if dom <= 0:
        raise LutError(f"map {m.label()}: in_domain must be positive")
    if dom > MAX_TABLE_ITEMS:
        # table.numel() >= dom always, so refuse before evaluating
        raise LutError(
            f"map {m.label()}: domain {dom} exceeds the "
            f"{MAX_TABLE_ITEMS}-item cap; narrow the domain")
    cpu = torch.device("cpu")
    with E.device_mode("vmap", cpu), torch.no_grad():
        table = torch.func.vmap(lambda i: txp.asarray(m.f(i)))(
            torch.arange(dom, dtype=torch.int32))
    if table.numel() > MAX_TABLE_ITEMS:
        raise LutError(
            f"map {m.label()}: table of {table.numel()} items exceeds the "
            f"{MAX_TABLE_ITEMS}-item cap; narrow the domain")
    return table


def _gatherer(table: torch.Tensor):
    """table[x] for a host item (numpy back) or a tensor (on its
    device; the table is copied to each device once)."""
    copies = {}

    def gather(idx, host: bool):
        if not isinstance(idx, torch.Tensor):
            idx = torch.as_tensor(np.asarray(idx))
        t = copies.get(str(idx.device))
        if t is None:
            t = copies[str(idx.device)] = table.to(idx.device)
        out = t[idx.to(torch.int64)]
        return out.cpu().numpy() if host else out
    return gather


def lut_map(m: ir.Map) -> ir.Map:
    """Rewrite one LUT-able Map into a table gather: either a declared
    scalar in_domain, or an inferred packed-bits adapter
    (`m.lut`, frontend/lutinfer.MapLut, the LUTAnalysis role)."""
    if m.lut is not None:
        # an oversize table, or a body that cannot be evaluated over its
        # domain at all, means "leave un-LUT'd", matching the
        # expression-call path's fallback and the no-flag behavior
        from ziria_tpu_torch.frontend.eval import ZiriaRuntimeError
        from ziria_tpu_torch.frontend.lutinfer import TableTooLarge
        try:
            take = _gatherer(m.lut.build_table())
        except (TableTooLarge, ZiriaRuntimeError):
            return m

        enc = m.lut.encoder()      # closes over the spec only, not the
        #                            FunDef/Ctx the adapter carries

        def gather(x, _take=take, _enc=enc):
            return _take(_enc(x), not isinstance(x, torch.Tensor))

        return ir.Map(gather, in_arity=m.in_arity, out_arity=m.out_arity,
                      name=f"lut[{m.label()}]")

    take = _gatherer(build_table(m))

    def gather(x, _take=take):
        return _take(x, not isinstance(x, torch.Tensor))

    return ir.Map(gather, in_arity=1, out_arity=m.out_arity,
                  name=f"lut[{m.label()}]")


def autolut(comp: ir.Comp) -> ir.Comp:
    """Rewrite every Map with a declared in_domain (or an inferred
    lutinfer adapter) into its LUT form. Structure-preserving everywhere
    else; semantics identical."""
    def walk(c: ir.Comp) -> ir.Comp:
        if isinstance(c, ir.Map) and (c.in_domain is not None
                                      or c.lut is not None):
            return lut_map(c)
        return ir.map_children(c, lambda ch, _binds: walk(ch))

    return walk(comp)
