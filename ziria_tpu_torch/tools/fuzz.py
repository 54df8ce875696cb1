"""Program-space fuzzing of the port's executors (counterpart of the
repo's four fuzz harnesses, ``tests/test_fuzz.py``,
``test_fuzz_comp.py``, ``test_fuzz_surface.py`` and
``test_fuzz_parallel.py``).

Each family draws seeded random programs with the reference harness's
own draws, so seed *s* names the same program in both packages:

- ``pipeline`` (24 seeds): combinator pipelines of 1-4 stages, maps and
  stateful stages with ``advance`` or ``memory``;
- ``comp`` (16): ``repeat`` bodies of take/takes/emit/do/for in
  ``.zir``;
- ``surface`` (20), ``bitmix`` (8), ``int8_autolut`` (8): ``.zir``
  function bodies with ifs, fors, whiles and arrays, bit operands
  mixed with out-of-range constants, and int8 functions that AutoLUT
  rewrites;
- ``sp`` (24), ``pp`` (16), ``dpsp`` (8): pipelines split over a
  stream axis, a stage axis and a (dp, sp) grid;
- ``chunked`` (24), ``framebatch`` (10): ``.zir`` programs with
  stream-control loops (chunk machines), one stream or ragged frame
  sets.

A combinator stage is drawn as a *spec* (plain data), which
:func:`build_stage` turns into the port's stage (torch lambdas); the
``.zir`` generators below are copies of the reference harnesses' and
the tests hold their text to the reference's for every seed.

:func:`run_case` runs one case through every executor of the port that
the reference harness runs it through, on one device (``cuda`` unless
the caller passes another, as at every entry point of the port; mesh
axes over entries of that device), and :func:`mismatches` holds the outputs to a
reference output: the interpreter's and the chunk-machine executors'
exactly (``terminated_by`` too), the jit backend's as a prefix of it
(the jit tail policy drops sub-iteration remainders at the end of the
stream) and every other jit-family executor's equal to the jit's. The
CPU tests take the JAX package's interpreter as the reference;
``chip_smoke.py``'s fuzz phase, on the card, the port's interpreter on
the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

#: cases per family, as in the reference harnesses
CASES = {"pipeline": 24, "comp": 16, "surface": 20, "bitmix": 8,
         "int8_autolut": 8, "sp": 24, "pp": 16, "dpsp": 8, "chunked": 24,
         "framebatch": 10}

#: the families whose programs are ``.zir`` sources
ZIR_FAMILIES = ("comp", "surface", "bitmix", "int8_autolut", "chunked",
                "framebatch")

PIPELINE_KINDS = ["affine", "mod", "sum4", "expand", "clip", "ctr", "fir"]
SP_POOL = ["affine", "mod", "pairsum", "dup", "counter", "window"]
DPSP_POOL = ["affine", "mod", "counter", "window"]


# ------------------------------------------------------------ stage specs

def rand_stage_spec(rng) -> Dict[str, Any]:
    """One stage of the ``pipeline`` family (tests/test_fuzz.py's
    ``_rand_stage`` draws)."""
    kind = rng.choice(PIPELINE_KINDS)
    if kind == "affine":
        a, b = int(rng.integers(1, 5)), int(rng.integers(-3, 4))
        return {"kind": "affine", "mul": a, "add": b,
                "name": f"affine{a}_{b}"}
    if kind == "mod":
        m = int(rng.integers(3, 200))
        return {"kind": "mod", "m": m, "name": f"mod{m}"}
    if kind == "sum4":
        return {"kind": "sum", "n": 4, "name": "sum4"}
    if kind == "expand":
        return {"kind": "pair", "second": "neg", "name": "expand"}
    if kind == "clip":
        lo, hi = -int(rng.integers(5, 60)), int(rng.integers(5, 60))
        return {"kind": "clip", "lo": lo, "hi": hi, "name": f"clip{lo}_{hi}"}
    if kind == "ctr":
        s0 = int(rng.integers(0, 7))
        return {"kind": "counter", "s0": s0, "name": f"ctr{s0}"}
    k = int(rng.integers(2, 6))
    return {"kind": "window", "taps": [1] * k, "name": f"fir{k}"}


def gen_stage_spec(rng, pool) -> Dict[str, Any]:
    """One stage of the parallel families (tests/test_fuzz_parallel.py's
    ``_gen_stage`` draws)."""
    kind = rng.choice(pool)
    a = int(rng.integers(0, 1000))
    b = int(rng.integers(1, 7))
    if kind == "affine":
        return {"kind": "affine", "mul": b, "add": a, "name": f"aff{b}_{a}"}
    if kind == "mod":
        m = int(rng.choice([17, 251, 4093]))
        return {"kind": "mod", "m": m, "name": f"mod{m}"}
    if kind == "pairsum":
        return {"kind": "sum", "n": 2, "name": "pairsum"}
    if kind == "dup":
        return {"kind": "pair", "second": "inc", "name": "dup"}
    if kind == "counter":
        s0 = int(rng.integers(0, 5))
        return {"kind": "counter", "s0": s0, "name": f"ctr{s0}"}
    if kind == "window":
        w = int(rng.choice([2, 3, 4]))
        taps = rng.integers(-3, 4, size=w).astype(np.int32)
        return {"kind": "window", "taps": [int(t) for t in taps],
                "name": f"win{w}"}
    raise AssertionError(kind)


def build_stage(spec: Dict[str, Any]):
    """The port's stage for a spec: torch lambdas that take tensors (the
    interpreter's items, the jit backend's chunks) on any device."""
    import torch

    import ziria_tpu_torch as z
    kind, name = spec["kind"], spec["name"]
    if kind == "affine":
        return z.zmap(lambda x, _a=spec["mul"], _b=spec["add"]: x * _a + _b,
                      name=name)
    if kind == "mod":
        return z.zmap(lambda x, _m=spec["m"]: x % _m, name=name)
    if kind == "sum":
        return z.zmap(lambda v: v.sum(0), in_arity=spec["n"], out_arity=1,
                      name=name)
    if kind == "pair":
        if spec["second"] == "neg":
            return z.zmap(lambda x: torch.stack([x, -x]), in_arity=1,
                          out_arity=2, name=name)
        return z.zmap(lambda x: torch.stack([x, x + 1]), in_arity=1,
                      out_arity=2, name=name)
    if kind == "clip":
        return z.zmap(lambda x, _l=spec["lo"], _h=spec["hi"]:
                      torch.clamp(x, _l, _h), name=name)
    if kind == "counter":
        return z.map_accum(lambda s, x: (s + 1, x + s), spec["s0"],
                           name=name, advance=lambda s, n: s + n)
    taps = np.asarray(spec["taps"], np.int32)

    def step(s, x, _t=taps):
        s = torch.as_tensor(s)
        x = torch.as_tensor(x, dtype=torch.int32, device=s.device)
        s2 = torch.cat([s[1:], x.reshape(1)])
        return s2, (s2 * torch.as_tensor(_t, device=s.device)).sum()

    return z.map_accum(step, np.zeros(len(taps), np.int32), name=name,
                       memory=len(taps))


def build_pipeline(specs, single: bool = False):
    """A ``>>>`` pipeline of the specs' stages (the lone stage itself
    with ``single`` and one spec, as tests/test_fuzz.py builds it)."""
    import ziria_tpu_torch as z
    stages = [build_stage(s) for s in specs]
    return stages[0] if single and len(stages) == 1 else z.pipe(*stages)


# ------------------------------------------------------------ the cases

def pipeline_case(seed: int):
    """(specs, xs) of tests/test_fuzz.py's ``_rand_pipeline(seed)``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    specs = [rand_stage_spec(rng) for _ in range(n)]
    n_items = int(rng.integers(50, 2500))
    xs = rng.integers(-100, 100, n_items).astype(np.int64)
    return specs, xs


def sp_case(seed: int):
    """(specs, xs) of the reference's ``test_fuzz_sp_equals_single_chip``."""
    rng = np.random.default_rng(1000 + seed)
    specs = [gen_stage_spec(rng, SP_POOL)
             for _ in range(int(rng.integers(1, 4)))]
    n = int(rng.integers(50, 3000))
    return specs, rng.integers(-1000, 1000, size=n).astype(np.int32)


def pp_case(seed: int, take_of):
    """(specs, width, M, r, xs) of the reference's
    ``test_fuzz_pp_equals_fused``: K stages, the width, then M macro
    steps and a ragged remainder r < take, where ``take_of(specs,
    width)`` is the stage pipeline's macro take (the draws after it
    depend on it)."""
    rng = np.random.default_rng(2000 + seed)
    K = int(rng.choice([2, 4]))
    specs = [gen_stage_spec(rng, SP_POOL) for _ in range(K)]
    width = int(rng.choice([1, 3]))
    take = take_of(specs, width)
    M = int(rng.integers(1, 7))
    r = int(rng.integers(0, take))
    xs = rng.integers(-1000, 1000, size=M * take + r).astype(np.int32)
    return specs, width, M, r, xs


def dpsp_case(seed: int):
    """(specs, width, batch) of the reference's
    ``test_fuzz_dp_x_sp_equals_per_frame``."""
    rng = np.random.default_rng(3000 + seed)
    specs = [gen_stage_spec(rng, DPSP_POOL)
             for _ in range(int(rng.integers(1, 4)))]
    width = int(rng.choice([4, 16]))
    B = int(rng.choice([2, 4]))
    N = 4 * width * int(rng.integers(1, 5))
    if rng.random() < 0.5:
        N += int(rng.integers(1, 4 * width))
    batch = rng.integers(-1000, 1000, size=(B, N)).astype(np.int32)
    return specs, width, batch


def gen_comp_body(rng):
    """tests/test_fuzz_comp.py's ``_gen_body``: (lines, n_take)."""
    lines = []
    vals = []
    arrs = []
    n_take = 0
    for _ in range(int(rng.integers(1, 5))):
        kind = rng.choice(["take", "takes", "do", "emit_for"])
        if kind == "take":
            v = f"x{len(vals)}"
            lines.append(f"  {v} <- take;")
            vals.append(v)
            n_take += 1
        elif kind == "takes":
            k = int(rng.choice([2, 4, 8]))
            a = f"v{len(arrs)}"
            lines.append(f"  ({a} : arr[{k}] int32) <- takes {k};")
            arrs.append((a, k))
            n_take += k
        elif kind == "do" and (vals or arrs):
            src = vals[-1] if vals and (not arrs or rng.random() < 0.5) \
                else f"{arrs[-1][0]}[{int(rng.integers(0, arrs[-1][1]))}]"
            lines.append(f"  do {{ s := s + {src} }};")
        elif kind == "emit_for" and arrs:
            a, k = arrs[int(rng.integers(0, len(arrs)))]
            lines.append(f"  for i in [0, {k}] {{ emit {a}[i] * 2 + s }};")
    if n_take == 0:
        lines.insert(0, "  x0 <- take;")
        vals.append("x0")
        n_take = 1
    src = vals[-1] if vals else f"{arrs[-1][0]}[0]"
    lines.append(f"  emit {src} + s;")
    lines.append("  do { s := s + 1 }")
    return lines, n_take


def comp_case(seed: int):
    """(src, xs) of tests/test_fuzz_comp.py's ``_gen_program(seed)``."""
    rng = np.random.default_rng(seed)
    body, n_take = gen_comp_body(rng)
    src = ("let comp main = read[int32] >>> {\n"
           "  var s : int32 := 0;\n"
           "  repeat {\n" + "\n".join("  " + ln for ln in body) +
           "\n  }\n} >>> write[int32]\n")
    iters = int(rng.integers(3, 30))
    xs = rng.integers(-100, 100, iters * n_take).astype(np.int32)
    return src, xs


def gen_expr(rng, depth, names):
    """tests/test_fuzz_surface.py's ``_gen_expr``."""
    if depth <= 0 or rng.random() < 0.3:
        if names and rng.random() < 0.7:
            return str(rng.choice(names))
        return str(int(rng.integers(-20, 21)))
    op = rng.choice(["+", "-", "*", "%", "&", "|", "^", ">>", "<<"])
    a = gen_expr(rng, depth - 1, names)
    b = gen_expr(rng, depth - 1, names)
    if op == "%":
        return f"(({a}) % {int(rng.integers(2, 40))})"
    if op in (">>", "<<"):
        return f"(({a}) {op} {int(rng.integers(0, 5))})"
    return f"(({a}) {op} ({b}))"


def gen_stmts(rng, depth, names, indent, arrs=()):
    """tests/test_fuzz_surface.py's ``_gen_stmts``."""
    pad = "  " * indent
    lines = []
    for _ in range(int(rng.integers(1, 4))):
        kind = rng.choice(["assign", "if", "for", "while", "local",
                           "arr", "aset"])
        if kind == "arr" and depth > 0 and not arrs:
            nm = f"v{int(rng.integers(0, 1000))}"
            lines.append(f"{pad}var {nm} : arr[16] int32;")
            arrs = arrs + (nm,)
            continue
        if kind in ("arr", "aset") and arrs:
            a = rng.choice(arrs)
            idx = f"((({gen_expr(rng, 1, names)}) % 16 + 16) % 16)"
            if kind == "aset":
                lines.append(f"{pad}{a}[{idx}] := "
                             f"{gen_expr(rng, 1, names)};")
            else:
                lines.append(f"{pad}acc := acc + {a}[{idx}];")
            continue
        if kind in ("arr", "aset"):
            kind = "assign"
        if kind == "local" and depth > 0:
            nm = f"t{int(rng.integers(0, 1000))}"
            lines.append(f"{pad}var {nm} : int32 := "
                         f"{gen_expr(rng, 2, names)};")
            names = names + [nm]
        elif kind == "assign":
            lines.append(f"{pad}acc := {gen_expr(rng, 2, names)};")
        elif kind == "if" and depth > 0:
            cond = f"({gen_expr(rng, 1, names)}) > " \
                   f"{int(rng.integers(-10, 10))}"
            lines.append(f"{pad}if {cond} then {{")
            lines += gen_stmts(rng, depth - 1, names, indent + 1, arrs)
            lines.append(f"{pad}}} else {{")
            lines += gen_stmts(rng, depth - 1, names, indent + 1, arrs)
            lines.append(f"{pad}}};")
        elif kind == "for" and depth > 0:
            n = int(rng.choice([3, 7, 30, 40]))
            v = f"i{int(rng.integers(0, 1000))}"
            lines.append(f"{pad}for {v} in [0, {n}] {{")
            lines += gen_stmts(rng, depth - 1, names + [v], indent + 1,
                               arrs)
            lines.append(f"{pad}}};")
        elif kind == "while" and depth > 0:
            g = f"g{int(rng.integers(0, 1000))}"
            lines.append(f"{pad}var {g} : int32 := "
                         f"(({gen_expr(rng, 1, names)}) % 7 + 7) % 7;")
            lines.append(f"{pad}while ({g} > 0) {{")
            lines += gen_stmts(rng, depth - 1, names + [g], indent + 1,
                               arrs)
            lines.append(f"{pad}  {g} := {g} - 1")
            lines.append(f"{pad}}};")
        else:
            lines.append(f"{pad}acc := {gen_expr(rng, 2, names)};")
    return lines


def surface_case(seed: int):
    """(src, xs) of tests/test_fuzz_surface.py's ``_gen_program(seed)``."""
    rng = np.random.default_rng(seed)
    body = "\n".join(gen_stmts(rng, 2, ["x", "acc"], 1))
    src = f"""
fun f(x: int32) : int32 {{
  var acc : int32 := x;
{body};
  return acc
}}
let comp main = read[int32] >>> map f >>> write[int32]
"""
    n = int(rng.integers(8, 64))
    return src, rng.integers(-1000, 1000, n).astype(np.int32)


def bitmix_case(seed: int):
    """(src, xs) of case `seed` (0-7) of the reference's
    ``test_fuzz_surface_bit_mixing_agreement`` (rng seed 2000 + seed)."""
    rng = np.random.default_rng(2000 + seed)
    terms = []
    for _t in range(int(rng.integers(2, 6))):
        c = int(rng.integers(1, 1025))
        i = int(rng.integers(0, 8))
        if rng.random() < 0.5:
            terms.append(f"{c} * b[{i}]")
        else:
            cmp_v = int(rng.integers(-4, 300))
            terms.append(f"(if b[{i}] > {cmp_v} then {c} else "
                         f"(0 - {c}))")
    body = " + ".join(terms)
    src = f"""
fun f(b: arr[8] bit) : int32 {{
  return {body}
}}
let comp main = read[bit] >>> map f >>> write[int32]
"""
    return src, rng.integers(0, 2, 8 * 16).astype(np.uint8)


def int8_autolut_case(seed: int):
    """(src, xs) of case `seed` (0-7) of the reference's
    ``test_fuzz_surface_int8_autolut_agreement`` (rng seed 1000 + seed)."""
    rng = np.random.default_rng(1000 + seed)
    body = "\n".join(gen_stmts(rng, 2, ["x", "acc"], 1))
    src = f"""
fun f(x: int8) : int8 {{
  var acc : int32 := int32(x);
{body};
  return int8(acc)
}}
let comp main = read[int8] >>> map f >>> write[int8]
"""
    return src, rng.integers(-128, 128, 40).astype(np.int8)


def gen_chunk_program(rng):
    """tests/test_fuzz_parallel.py's ``_gen_chunk_program``: (src, xs)."""
    n_iter = int(rng.integers(40, 200))
    lead = int(rng.integers(0, 30))
    th = int(rng.integers(50, 5000))
    body = []
    body.append(f"""
  var s : int32 := 0;
  var g : int32 := 0;
  var armed : bool := false;
  while (!armed) {{
    x <- take;
    do {{
      s := s + x * x - (s / 5);
      if (s % 10000 > {th}) then {{ armed := true }};
      g := g + 1
    }}
  }};
  emit s;
  times {n_iter} {{
    var v : int32 := 0;
    if (g < {lead + 40}) then {{ do {{ v := g * 3 }} }}
    else {{ y <- take; do {{ v := y + s }} }};
    do {{
      g := g + 1;
      if (v % 2 == 0) then {{ s := s + v }} else {{ s := s - v }}
    }}
  }};
  emit s;
  times {int(rng.integers(2, 5))} {{ emit g; do {{ g := g + 7 }} }}""")
    src = ("let comp main = read[int32] >>> {" + "".join(body)
           + "\n} >>> write[int32]\n")
    n = int(rng.integers(100, 400))
    xs = rng.integers(-500, 500, size=n).astype(np.int32)
    return src, xs


def chunked_case(seed: int):
    """(src, xs) of the reference's
    ``test_fuzz_chunked_loops_equal_oracle``."""
    return gen_chunk_program(np.random.default_rng(4000 + seed))


def framebatch_case(seed: int):
    """(src, frames) of the reference's
    ``test_fuzz_framebatch_equals_per_frame``."""
    rng = np.random.default_rng(6000 + seed)
    src, _xs = gen_chunk_program(rng)
    n_frames = int(rng.integers(2, 7))
    frames = [rng.integers(-500, 500, size=int(rng.integers(30, 400)))
              .astype(np.int32) for _ in range(n_frames)]
    return src, frames


ZIR_CASES = {"comp": comp_case, "surface": surface_case,
             "bitmix": bitmix_case, "int8_autolut": int8_autolut_case,
             "chunked": chunked_case, "framebatch": framebatch_case}


# ------------------------------------------------------------ executors

def entries(device, n: int, shape=None, names=("sp",)):
    """A mesh of `n` entries of one device (the reference tests' virtual
    devices): ``shape`` and ``names`` give its axes."""
    import torch

    from ziria_tpu_torch.parallel.mesh import Mesh
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device(device)] * n
    return Mesh(devs.reshape(shape or (n,)), names)


def result(r) -> Tuple[np.ndarray, str]:
    """An interpreter Result as (outputs, terminated_by)."""
    return np.asarray(r.out_array()), r.terminated_by


def interp(comp, xs):
    """The port's interpreter on the host: items as CPU tensors (the
    combinator stages' lambdas are torch) or as they are (``.zir``)."""
    import torch

    from ziria_tpu_torch.interp.interp import run
    items = list(torch.from_numpy(np.asarray(xs))) \
        if not isinstance(xs, list) else xs
    return result(run(comp, items))


def _lower_pp(specs, width, device):
    """The ``pp`` case's stage pipeline, one stage an entry of
    `device`."""
    import ziria_tpu_torch as z
    from ziria_tpu_torch.parallel.stages import lower_stage_parallel
    comp = z.par_pipe(*[build_stage(s) for s in specs])
    return lower_stage_parallel(comp, entries(device, len(specs),
                                              names=("pp",)),
                                width=width, in_item=((), np.int32))


def case_of(family: str, seed: int, device="cuda"):
    """The case (program and inputs) of `family` at `seed`; a ``pp`` case
    lowers its stage pipeline on `device` to draw its lengths."""
    if family in ZIR_CASES:
        return ZIR_CASES[family](seed)
    if family == "pipeline":
        return pipeline_case(seed)
    if family == "sp":
        return sp_case(seed)
    if family == "dpsp":
        return dpsp_case(seed)
    if family == "pp":
        return pp_case(seed, lambda specs, width:
                       _lower_pp(specs, width, device).take)
    raise ValueError(f"unknown fuzz family {family!r}")


def run_case(family: str, case, device="cuda",
             n_entries: int = 8) -> Dict[str, Any]:
    """Every executor of the port that the reference harness runs the
    case through, on `device` (mesh axes over `n_entries` entries of
    it): ``{executor: output}``; interpreter outputs are (outputs,
    terminated_by), per frame a list of them."""
    from ziria_tpu_torch.backend import hybrid
    from ziria_tpu_torch.backend.execute import run_jit, run_jit_carry
    from ziria_tpu_torch.frontend import compile_source
    from ziria_tpu_torch.interp.interp import run
    from ziria_tpu_torch.parallel import streampar

    outs: Dict[str, Any] = {}
    if family in ("comp", "surface", "bitmix", "int8_autolut"):
        src, xs = case
        comp = compile_source(src).comp
        outs["interp"] = interp(comp, list(xs))
        outs["jit"] = run_jit(comp, xs, device=device)
        if family == "int8_autolut":
            from ziria_tpu_torch.core.autolut import autolut
            lutted = autolut(compile_source(src, autolut=True).comp)
            outs["autolut"] = run_jit(lutted, xs, device=device)
        return outs
    if family == "chunked":
        src, xs = case
        comp = compile_source(src).comp
        outs["interp"] = interp(comp, list(xs))
        outs["hybrid"] = result(run(hybrid.hybridize(comp, device=device),
                                    list(xs)))
        return outs
    if family == "framebatch":
        from ziria_tpu_torch.backend.framebatch import StepBatcher, run_many
        src, frames = case
        comp = compile_source(src).comp
        outs["interp"] = [interp(comp, list(f)) for f in frames]
        hyb = hybrid.hybridize(comp, device=device)
        outs["run_many"] = [result(r) for r in run_many(
            hyb, [list(f) for f in frames],
            batcher=StepBatcher(len(frames)))]
        return outs
    if family == "pipeline":
        from ziria_tpu_torch.core import ir
        from ziria_tpu_torch.core.opt import fold
        from ziria_tpu_torch.parallel.autosplit import auto_pipeline
        from ziria_tpu_torch.parallel.stages import lower_stage_parallel
        specs, xs = case
        comp = build_pipeline(specs, single=True)
        outs["interp"] = interp(comp, xs)
        outs["jit"] = run_jit(comp, xs, device=device)
        outs["fold"] = run_jit(fold(comp), xs, device=device)
        outs["sp"] = streampar.stream_parallel(
            comp, xs, entries(device, n_entries))
        if len(ir.pipeline_stages(comp)) >= 2:
            pp = lower_stage_parallel(
                auto_pipeline(comp, 2), entries(device, 2, names=("pp",)),
                in_item=((), xs.dtype), width=2)
            m = xs.shape[0] // pp.take
            if m:
                ys = np.asarray(pp.run(xs[: m * pp.take].reshape(
                    (m, pp.take) + xs.shape[1:])))
                outs["pp"] = ys.reshape((m * pp.emit,) + ys.shape[2:])
        return outs
    if family == "sp":
        specs, xs = case
        comp = build_pipeline(specs)
        outs["interp"] = interp(comp, xs)
        outs["jit"] = run_jit(comp, xs, device=device)
        outs["sp"] = streampar.stream_parallel(
            comp, xs, entries(device, n_entries))
        return outs
    if family == "pp":
        specs, width, M, _r, xs = case
        seq = build_pipeline(specs)
        outs["interp"] = interp(seq, xs)
        outs["jit"] = run_jit(seq, xs, device=device)
        pp = _lower_pp(specs, width, device)
        ys, carry = pp.run_carry(xs[: M * pp.take].reshape(M, pp.take))
        tail, _ = run_jit_carry(seq, xs[M * pp.take:], carry=carry, width=1,
                                device=device)
        outs["pp"] = np.concatenate([np.asarray(ys).reshape(-1),
                                     np.asarray(tail).reshape(-1)])
        return outs
    if family == "dpsp":
        specs, width, batch = case
        comp = build_pipeline(specs)
        outs["interp"] = [interp(comp, f) for f in batch]
        outs["jit"] = [run_jit(comp, f, width=width, device=device)
                       for f in batch]
        grid = (2, n_entries // 2)
        got = streampar.stream_parallel_batched(
            comp, batch, entries(device, n_entries, grid, ("dp", "sp")),
            width=width)
        outs["dpsp"] = list(got)
        return outs
    raise ValueError(f"unknown fuzz family {family!r}")


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _prefix(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return got.shape[0] <= want.shape[0] and \
        _equal(got, want[: got.shape[0]])


def mismatches(family: str, outs: Dict[str, Any], want) -> List[str]:
    """What of `outs` disagrees with the reference output `want` (an
    interpreter output, per frame a list of them): an empty list when
    every executor agrees."""
    bad = []
    frames = family in ("framebatch", "dpsp")
    wants = want if frames else [want]
    for name, got in outs.items():
        gots = got if frames else [got]
        if len(gots) != len(wants):
            bad.append(f"{name}: {len(gots)} frames, want {len(wants)}")
            continue
        for k, (g, w) in enumerate(zip(gots, wants)):
            tag = f"{name} frame {k}" if frames else name
            if isinstance(g, tuple):          # an interpreter Result
                if not (_equal(g[0], w[0]) and g[1] == w[1]):
                    bad.append(f"{tag}: {g[1]} {np.asarray(g[0])[:8]} != "
                               f"{w[1]} {np.asarray(w[0])[:8]}")
            elif family in ZIR_FAMILIES:
                # whole iterations only: the jit output is the oracle's
                if not _equal(g, w[0]):
                    bad.append(f"{tag}: {np.asarray(g)[:8]} != "
                               f"{np.asarray(w[0])[:8]}")
            elif name == "jit":
                if not _prefix(g, w[0]):
                    bad.append(f"{tag}: not a prefix of the interpreter's")
            else:
                jit = outs["jit"][k] if frames else outs["jit"]
                ok = _prefix(g, jit) if name == "pp" and family == \
                    "pipeline" else _equal(g, jit)
                if not ok:
                    bad.append(f"{tag}: differs from the jit backend's")
    return bad
