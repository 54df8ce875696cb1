"""Elaboration: surface AST → core IR (counterpart of
ziria_tpu/frontend/elab.py).

The frontend's middle end. Computation AST nodes become core IR nodes
(core/ir.py); expressions become closures over the runtime `ir.Env`
evaluated by the staged evaluator (frontend/eval.py), so one semantics
serves the interpreter (host values) and the device paths (tensors). Comp
functions are inlined at elaboration — the role the reference's
inliner/fold pass plays before codegen (SURVEY.md §2.1) — and
`let`-bound expressions are evaluated at elaboration time when they are
static, which is the partial-evaluation half of the reference's
`Interpreter.hs`.

After elaboration, `core.localize` rewrites stateful repeats
(LetRef⁺(Repeat)) into explicit-state MapAccums so parsed programs
reach the fused jit path.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field as dfield
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.localize import localize
from ziria_tpu_torch.frontend import ast as A
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.frontend.externals import BUILTINS, resolve_ext
from ziria_tpu_torch.frontend.parser import parse_program


class ElabError(Exception):
    pass


def _err(src: str, loc, msg: str) -> ElabError:
    return ElabError(f"{src}:{loc[0]}:{loc[1]}: {msg}")


# --------------------------------------------------------------------------
# Runtime scope: routes name lookup/assignment through ir.Env
# --------------------------------------------------------------------------


class _EnvRefCell:
    """Write-through view of an ir.Env ref, so eval's staged-if merge can
    snapshot and update stream-level `var`s."""

    __slots__ = ("_env", "_name")

    def __init__(self, env: ir.Env, name: str):
        self._env = env
        self._name = name

    @property
    def value(self):
        return self._env.lookup(self._name)

    @value.setter
    def value(self, v):
        self._env.set(self._name, v)


def _env_ref_names(env: ir.Env) -> List[str]:
    """Ref names visible (and writable) from `env` — a ref shadowed by
    an inner immutable bind (e.g. a comp-fun param named like an outer
    `var`) is excluded: lookup resolves to the bind, so the block can
    neither read nor legally write the outer ref, and exposing it as a
    mutable cell made the staged-if merge explode on write-back."""
    out, seen = [], set()
    e = env
    while e is not None:
        for n in e._vars:
            seen.add(n)                      # inner binds shadow
        for n in e._refs:
            if n not in seen:
                seen.add(n)
                out.append(n)
        e = e._parent
    return out


class RuntimeScope(E.Scope):
    """Evaluation scope backed by the runtime ir.Env (bind vars + refs),
    falling back to the elaborator's static scope."""

    def __init__(self, env: ir.Env, static: E.Scope, var_types: Dict,
                 ctx: E.Ctx):
        super().__init__(parent=static)
        self.env = env
        self.var_types = var_types
        self.ctx = ctx

    def find(self, name):
        if name in self.cells:      # do-block locals win
            return self.cells[name]
        try:
            v = self.env.lookup(name)
        except KeyError:
            return super().find(name)   # static (global/const) fallback
        return E.Cell(v, self.var_types.get(name), True)

    def assign(self, name, value, ctx, loc=(0, 0)):
        if name in self.cells:      # do-block local
            return super().assign(name, value, ctx, loc)
        ty = self.var_types.get(name)
        if ty is not None:
            value = E.cast_value(ty, value, ctx.structs,
                                 lambda x: ctx.static_eval(x, self),
                                 fxp=ctx.fxp_complex16)
        try:
            self.env.set(name, value)
            return
        except KeyError as e:
            if "immutable" in str(e):
                raise E.ZiriaRuntimeError(str(e)) from None
        super().assign(name, value, ctx, loc)

    def own_mutable_cells(self):
        cells = list(super().own_mutable_cells())
        cells.extend((n, _EnvRefCell(self.env, n))
                     for n in _env_ref_names(self.env))
        return cells


# --------------------------------------------------------------------------
# Free variables (expression level)
# --------------------------------------------------------------------------


def free_vars(e: Optional[A.Expr]) -> FrozenSet[str]:
    if e is None:
        return frozenset()
    out = set()

    def walk(x):
        if x is None:
            return
        if isinstance(x, A.EVar):
            out.add(x.name)
        elif isinstance(x, A.EUn):
            walk(x.e)
        elif isinstance(x, A.EBin):
            walk(x.a)
            walk(x.b)
        elif isinstance(x, A.ECond):
            walk(x.c)
            walk(x.a)
            walk(x.b)
        elif isinstance(x, A.ECall):
            for a in x.args:
                walk(a)
        elif isinstance(x, A.EIdx):
            walk(x.arr)
            walk(x.i)
        elif isinstance(x, A.ESlice):
            walk(x.arr)
            walk(x.i)
            walk(x.n)
        elif isinstance(x, A.EField):
            walk(x.e)
        elif isinstance(x, A.EArrLit):
            for a in x.elems:
                walk(a)
        elif isinstance(x, A.EStructLit):
            for _, a in x.fields:
                walk(a)

    walk(e)
    return frozenset(out)


# --------------------------------------------------------------------------
# Elaboration environment
# --------------------------------------------------------------------------


@dataclass
class ElabEnv:
    static: E.Scope
    runtime: FrozenSet[str] = frozenset()
    var_types: Dict[str, A.Ty] = dfield(default_factory=dict)
    var_lens: Dict[str, int] = dfield(default_factory=dict)
    comps: Dict[str, ir.Comp] = dfield(default_factory=dict)

    def with_runtime(self, name: str, ty: Optional[A.Ty] = None,
                     length: Optional[int] = None) -> "ElabEnv":
        vt = dict(self.var_types)
        vl = dict(self.var_lens)
        if ty is not None:
            vt[name] = ty
        else:
            vt.pop(name, None)
        if length is not None:
            vl[name] = length
        else:
            vl.pop(name, None)
        return ElabEnv(self.static, self.runtime | {name}, vt, vl,
                       dict(self.comps))

    def with_comp(self, name: str, c: ir.Comp) -> "ElabEnv":
        comps = dict(self.comps)
        comps[name] = c
        return ElabEnv(self.static, self.runtime, dict(self.var_types),
                       dict(self.var_lens), comps)

    def with_static(self, name: str, value: Any) -> "ElabEnv":
        s = self.static.child()
        s.declare(name, value, None, mutable=False)
        return ElabEnv(s, self.runtime, dict(self.var_types),
                       dict(self.var_lens), dict(self.comps))

    def static_names(self) -> FrozenSet[str]:
        out = set()
        s = self.static
        while s is not None:
            out.update(s.cells)
            s = s.parent
        return frozenset(out)


@dataclass
class CompiledProgram:
    """A compiled source program: the elaborated main pipeline plus the
    driver-facing stream item types recovered from read[t]/write[t]."""

    comp: ir.Comp
    in_ty: Optional[str] = None
    out_ty: Optional[str] = None
    name: str = "main"
    comps: Dict[str, ir.Comp] = dfield(default_factory=dict)


# file item types (runtime/buffers.py names) for read[t]/write[t]
_FILE_TY = {
    "bit": "bit", "bool": "bit",
    "int8": "int8", "int16": "int16", "int32": "int32", "int": "int32",
    "double": "float32",
    "complex16": "complex16", "complex32": "complex32",
}


# --------------------------------------------------------------------------
# The elaborator
# --------------------------------------------------------------------------


class Elaborator:
    def __init__(self, prog: A.Program, src_name: str = "<input>",
                 fxp_complex16: bool = False, autolut: bool = False):
        self.prog = prog
        self.src = src_name
        self.gscope = E.Scope()
        self.ctx = E.Ctx(exts=dict(BUILTINS),
                         fxp_complex16=fxp_complex16,
                         autolut=autolut)
        self.comp_funs: Dict[str, A.DFunComp] = {}
        # single source of truth for ext signatures: the evaluator's
        # registry (ctx.ext_sigs); self.ext_sigs aliases the SAME dict
        self.ext_sigs = self.ctx.ext_sigs
        self.top_comps: Dict[str, ir.Comp] = {}
        self.top_comp_asts: Dict[str, A.Comp] = {}
        self._inlining: List[str] = []

    # -------------------------------------------------------- static eval

    def st_eval(self, e: A.Expr, ee: Optional[ElabEnv] = None) -> Any:
        scope = ee.static if ee is not None else self.gscope
        return self.ctx.static_eval(e, scope)

    def try_st_eval(self, e: A.Expr, ee: ElabEnv) -> Tuple[bool, Any]:
        # never speculatively evaluate impure expressions (a user fun can
        # print/error — compile-time evaluation would fire the effect)
        if not _is_pure(e):
            return False, None
        fv = free_vars(e)
        # a runtime-bound name shadows any static global of the same name:
        # folding through it would silently substitute the global's value
        if not (fv <= ee.static_names()) or (fv & ee.runtime):
            return False, None
        try:
            return True, self.st_eval(e, ee)
        except (E.NotStatic, E.ZiriaRuntimeError):
            return False, None

    def st_int(self, e: A.Expr, ee: ElabEnv, what: str) -> int:
        ok, v = self.try_st_eval(e, ee)
        if not ok or not isinstance(v, (int, np.integer)) \
                or isinstance(v, bool):
            raise _err(self.src, e.loc,
                       f"{what} must be a compile-time static integer")
        return int(v)

    # -------------------------------------------------------- closures

    def closure(self, e: A.Expr, ee: ElabEnv,
                cast_ty: Optional[A.Ty] = None) -> Any:
        """Build the runtime Expr for `e`: a static value when possible,
        else a closure over ir.Env."""
        unknown = free_vars(e) - ee.static_names() - ee.runtime
        if unknown:
            raise _err(self.src, e.loc,
                       f"unbound variable(s) {sorted(unknown)}")
        # constant-fold pure closed expressions at elaboration time (the
        # partial-evaluation half of the reference's Interpreter.hs);
        # runtime-shadowed names block the fold (see try_st_eval)
        if _is_pure(e) and free_vars(e) <= ee.static_names() \
                and not (free_vars(e) & ee.runtime):
            try:
                v = E.eval_expr(e, ee.static, self.ctx)
                if cast_ty is not None:
                    v = E.cast_value(cast_ty, v, self.ctx.structs,
                                     lambda x: self.st_eval(x, ee),
                                     fxp=self.ctx.fxp_complex16)
                return v
            except Exception:
                pass
        static, vt, ctx = ee.static, ee.var_types, self.ctx

        def run(env: ir.Env, _e=e, _ty=cast_ty):
            scope = RuntimeScope(env, static, vt, ctx)
            v = E.eval_expr(_e, scope, ctx)
            if _ty is not None:
                v = E.cast_value(_ty, v, ctx.structs,
                                 lambda x: ctx.static_eval(x, scope),
                                 fxp=ctx.fxp_complex16)
            return v

        # expose the expression AST (+ Ctx for fun-body recursion) so
        # comp-level analyses (backend/chunked.py bounds, effects and
        # free-variable checks) can see through the closure
        run.z_expr = e
        run.z_ctx = ctx
        return run

    def stmts_closure(self, stmts: Tuple[A.Stmt, ...], ee: ElabEnv) -> Any:
        """Closure running a do-block; value = return value or None."""
        static, vt, ctx = ee.static, ee.var_types, self.ctx

        def run(env: ir.Env, _stmts=stmts):
            scope = RuntimeScope(env, static, vt, ctx)
            r = E.exec_stmts(_stmts, scope, ctx)
            return r[1] if r is not None else None

        # expose the statement AST (and the Ctx, for looking into called
        # funs) so the hybrid executor (backend/hybrid.py) can weigh
        # this block and decide whether to jit-compile it as a unit
        run.z_stmts = stmts
        run.z_ctx = ctx
        return run

    # -------------------------------------------------------- static_len

    def static_len(self, e: A.Expr, ee: ElabEnv) -> Optional[int]:
        """Static array length of `e`'s value, if derivable."""
        ok, v = self.try_st_eval(e, ee)
        if ok and np.shape(v):
            return int(np.shape(v)[0])
        if isinstance(e, A.EArrLit):
            return len(e.elems)
        if isinstance(e, A.ESlice):
            try:
                return self.st_int(e.n, ee, "slice length")
            except ElabError:
                return None
        if isinstance(e, A.EVar):
            if e.name in ee.var_lens:
                return ee.var_lens[e.name]
            ty = ee.var_types.get(e.name)
            return self._ty_len(ty, ee)
        if isinstance(e, A.ECall):
            if e.name in self.ctx.funs:
                return self._ty_len(self.ctx.funs[e.name].decl.ret_ty, ee)
            if e.name in self.ext_sigs:
                return self._ty_len(self.ext_sigs[e.name].ret_ty, ee)
            # casts preserve shape
            if e.name in E._BASE_TYPE_NAMES and len(e.args) == 1:
                return self.static_len(e.args[0], ee)
            return None
        if isinstance(e, A.ECond):
            a = self.static_len(e.a, ee)
            b = self.static_len(e.b, ee)
            return a if a == b else None
        if isinstance(e, A.EUn):
            return self.static_len(e.e, ee)
        if isinstance(e, A.EBin) and e.op not in ("&&", "||", "==", "!=",
                                                  "<", "<=", ">", ">="):
            return (self.static_len(e.a, ee)
                    or self.static_len(e.b, ee))
        return None

    def _ty_len(self, ty: Optional[A.Ty], ee: ElabEnv) -> Optional[int]:
        if isinstance(ty, A.TArr) and ty.n is not None:
            try:
                return self.st_int(ty.n, ee, "array length")
            except ElabError:
                return None
        return None

    # -------------------------------------------------------- comp elab

    def elab_comp(self, c: A.Comp, ee: ElabEnv) -> ir.Comp:
        if isinstance(c, A.CTake):
            return ir.take
        if isinstance(c, A.CTakes):
            return ir.takes(self.st_int(c.n, ee, "takes count"))
        if isinstance(c, A.CEmit):
            return ir.Emit(self.closure(c.e, ee))
        if isinstance(c, A.CEmits):
            n = self.static_len(c.e, ee)
            if n is None:
                raise _err(
                    self.src, c.loc,
                    "emits: cannot determine the array length statically; "
                    "annotate the source variable (var x : arr[N] t / "
                    "(x : arr[N] t) <- ...) or emit a slice x[0, N]")
            return ir.Emits(self.closure(c.e, ee), n)
        if isinstance(c, A.CReturn):
            return ir.Return(self.closure(c.e, ee))
        if isinstance(c, A.CDo):
            return ir.Return(self.stmts_closure(c.body, ee))
        if isinstance(c, A.CBind):
            first = self.elab_comp(c.first, ee)
            if c.var is None:
                return ir.Bind(first, None, self.elab_comp(c.rest, ee))
            length = None
            if isinstance(c.first, A.CTakes):
                length = self.st_int(c.first.n, ee, "takes count")
            ee2 = ee.with_runtime(c.var, c.var_ty, length)
            return ir.Bind(first, c.var, self.elab_comp(c.rest, ee2))
        if isinstance(c, A.CVarDecl):
            if c.ty is None:
                raise _err(self.src, c.loc, "var needs a type annotation")
            init = (self.closure(c.init, ee, cast_ty=c.ty)
                    if c.init is not None
                    else E.zero_value(c.ty, self.ctx.structs,
                                      lambda x: self.st_eval(x, ee),
                                      fxp=self.ctx.fxp_complex16))
            init = _device_init(init, c.ty)
            ln = self._ty_len(c.ty, ee)
            ee2 = ee.with_runtime(c.name, c.ty, ln)
            return ir.LetRef(c.name, init, self.elab_comp(c.rest, ee2))
        if isinstance(c, A.CLetDecl):
            ok, v = self.try_st_eval(c.e, ee)
            if ok and _is_pure(c.e):
                ee2 = ee.with_static(c.name, v)
                return self.elab_comp(c.rest, ee2)
            ln = self.static_len(c.e, ee)
            ee2 = ee.with_runtime(c.name, None, ln)
            return ir.Bind(ir.Return(self.closure(c.e, ee)), c.name,
                           self.elab_comp(c.rest, ee2))
        if isinstance(c, A.CLetComp):
            inner = self.elab_comp(c.c, ee)
            return self.elab_comp(c.rest, ee.with_comp(c.name, inner))
        if isinstance(c, A.CRepeat):
            return ir.Repeat(self.elab_comp(c.body, ee))
        if isinstance(c, A.CMap):
            return self._elab_map(c, ee)
        if isinstance(c, A.CPipe):
            up = self.elab_comp(c.up, ee)
            down = self.elab_comp(c.down, ee)
            return ir.ParPipe(up, down) if c.par else ir.Pipe(up, down)
        if isinstance(c, A.CIf):
            ok, v = self.try_st_eval(c.c, ee)
            if ok:
                if v:
                    return self.elab_comp(c.then, ee)
                return (self.elab_comp(c.els, ee) if c.els is not None
                        else ir.Return(None))
            els = (self.elab_comp(c.els, ee) if c.els is not None
                   else ir.Return(None))
            return ir.Branch(self.closure(c.c, ee),
                             self.elab_comp(c.then, ee), els)
        if isinstance(c, A.CFor):
            return self._elab_for(c, ee)
        if isinstance(c, A.CTimes):
            ok, n = self.try_st_eval(c.count, ee)
            count = int(n) if ok else self.closure(c.count, ee)
            return ir.For(None, count, self.elab_comp(c.body, ee))
        if isinstance(c, A.CWhile):
            return ir.While(self.closure(c.c, ee),
                            self.elab_comp(c.body, ee))
        if isinstance(c, A.CUntil):
            body = self.elab_comp(c.body, ee)
            cond = self.closure(c.c, ee)

            def neg(env, _c=cond):
                v = ir.eval_expr(_c, env)
                if E._is_batched(v):          # differs per firing (vmap)
                    return torch.logical_not(v)
                return not E._sync_bool(v)

            neg.z_expr = A.EUn(op="!", e=c.c, loc=c.loc)
            neg.z_ctx = self.ctx
            return ir.Bind(body, None, ir.While(neg, body))
        if isinstance(c, A.CCall):
            return self._elab_call(c, ee)
        if isinstance(c, (A.CRead, A.CWrite)):
            raise _err(self.src, c.loc,
                       "read/write may only appear at the ends of the "
                       "top-level pipeline")
        raise _err(self.src, getattr(c, "loc", (0, 0)),
                   f"unknown computation node {type(c).__name__}")

    def _elab_for(self, c: A.CFor, ee: ElabEnv) -> ir.Comp:
        ok_s, start = self.try_st_eval(c.start, ee)
        ok_n, n = self.try_st_eval(c.count, ee)
        count = int(n) if ok_n else self.closure(c.count, ee)
        if ok_s and int(start) == 0:
            body = self.elab_comp(c.body, ee.with_runtime(c.var))
            return ir.For(c.var, count, body)
        # non-zero / dynamic start: hidden index + per-iteration rebind
        hidden = f"__i_{c.var}"
        ee2 = ee.with_runtime(hidden).with_runtime(c.var)
        body = self.elab_comp(c.body, ee2)
        start_c = int(start) if ok_s else self.closure(c.start, ee)

        def offset(env, _h=hidden, _s=start_c):
            s = ir.eval_expr(_s, env)
            return env.lookup(_h) + s

        return ir.For(hidden, count, ir.Bind(ir.Return(offset), c.var, body))

    def _elab_map(self, c: A.CMap, ee: ElabEnv) -> ir.Comp:
        name = c.fname
        fd = self.ctx.funs.get(name)
        if fd is not None:
            d = fd.decl
            if len(d.params) != 1:
                raise _err(self.src, c.loc,
                           f"map {name}: needs a one-argument function")
            a = self._ty_len(d.params[0].ty, ee) or 1
            b = self._ty_len(d.ret_ty, ee) or 1
            dom = _domain_of(d.params[0].ty)
            ctx = self.ctx

            def f(x, _fd=fd, _ctx=ctx):
                return E.call_fun(_fd, [x], _ctx)

            lut = None
            if dom is None:
                # inferred LUT-ability (lutinfer, LUTAnalysis role):
                # packed multi-bit items like arr[8] bit
                from ziria_tpu_torch.frontend import lutinfer
                spec = lutinfer.spec_for_fun(name, fd, ctx)
                if spec is not None:
                    lut = lutinfer.MapLut(spec, fd, ctx)
            fxp = self.ctx.fxp_complex16
            return ir.Map(f, in_arity=a, out_arity=b, name=name,
                          in_domain=dom,
                          in_dtype=_dtype_of(d.params[0].ty, fxp),
                          out_dtype=_dtype_of(d.ret_ty, fxp),
                          lut=lut)
        if name in self.ext_sigs:
            d = self.ext_sigs[name]
            fn = self.ctx.exts[name]
            a = (self._ty_len(d.params[0].ty, ee) or 1) if d.params else 1
            b = self._ty_len(d.ret_ty, ee) or 1
            dom = _domain_of(d.params[0].ty) if d.params else None
            fxp = self.ctx.fxp_complex16
            if fxp and d.params:
                # the map form must honor the same ext-boundary policy
                # as expression calls: complex-typed params see
                # complex64, complex16 returns requantize (review r2)
                pty, rty = d.params[0].ty, d.ret_ty

                def fn(x, _fn=fn, _p=pty, _r=rty):
                    return E._fx_ext_ret(_fn(E._fx_ext_arg(x, _p)), _r)
            return ir.Map(fn, in_arity=a, out_arity=b, name=name,
                          in_domain=dom,
                          in_dtype=(_dtype_of(d.params[0].ty, fxp)
                                    if d.params else None),
                          out_dtype=_dtype_of(d.ret_ty, fxp))
        if name in self.ctx.exts:
            return ir.Map(self.ctx.exts[name], name=name)
        raise _err(self.src, c.loc, f"map: unknown function {name!r}")

    def _elab_call(self, c: A.CCall, ee: ElabEnv) -> ir.Comp:
        name = c.name
        if name in ee.comps:
            if c.args:
                raise _err(self.src, c.loc,
                           f"{name} is a computation binding, not a "
                           f"function — call it without arguments")
            return ee.comps[name]
        if name in self.top_comps:
            if c.args:
                raise _err(self.src, c.loc,
                           f"{name} is a computation binding, not a "
                           f"function — call it without arguments")
            return self.top_comps[name]
        d = self.comp_funs.get(name)
        if d is None:
            raise _err(self.src, c.loc,
                       f"unknown computation {name!r}")
        if len(c.args) != len(d.params):
            raise _err(self.src, c.loc,
                       f"{name}: expected {len(d.params)} args, got "
                       f"{len(c.args)}")
        if name in self._inlining:
            raise _err(self.src, c.loc,
                       f"recursive comp function {name!r} is not "
                       f"supported (streams recurse via repeat/while)")
        self._inlining.append(name)
        try:
            # comp funs are top-level: the body sees globals + its params
            # only. Static args bind at elaboration time; runtime args
            # bind through the env (Bind(Return(closure), name, ...)).
            ee2 = ElabEnv(self.gscope)
            runtime_binds: List[Tuple[str, Any]] = []
            for p, a in zip(d.params, c.args):
                ok, v = self.try_st_eval(a, ee)
                if ok and _is_pure(a):
                    if p.ty is not None:
                        v = E.cast_value(p.ty, v, self.ctx.structs,
                                         lambda x: self.st_eval(x, ee),
                                         fxp=self.ctx.fxp_complex16)
                    ee2 = ee2.with_static(p.name, v)
                else:
                    ln = self.static_len(a, ee)
                    ee2 = ee2.with_runtime(
                        p.name, p.ty,
                        ln or self._ty_len(p.ty, ee))
                    runtime_binds.append(
                        (p.name, self.closure(a, ee, cast_ty=p.ty)))
            body = self.elab_comp(d.body, ee2)
            # evaluate ALL argument closures before binding ANY parameter:
            # binding param i before evaluating argument j>i would let the
            # fresh binding shadow a caller variable of the same name.
            # Stage through unique temps, then alias params to them.
            temps = []
            for pname, cl in runtime_binds:
                self._tmp = getattr(self, "_tmp", 0) + 1
                temps.append((f"__arg{self._tmp}_{pname}", pname, cl))
            for tname, pname, _ in reversed(temps):
                def alias(env, _t=tname):
                    return env.lookup(_t)
                body = ir.Bind(ir.Return(alias), pname, body)
            for tname, _, cl in reversed(temps):
                body = ir.Bind(ir.Return(cl), tname, body)
            return body
        finally:
            self._inlining.pop()

    # -------------------------------------------------------- program

    def elaborate(self) -> "Elaborator":
        for d in self.prog.decls:
            if isinstance(d, A.DStruct):
                self.ctx.structs[d.name] = E.StructDef(d.name, d.fields)
            elif isinstance(d, A.DFun):
                self.ctx.funs[d.name] = E.FunDef(d, self.gscope)
            elif isinstance(d, A.DExt):
                try:
                    fn = resolve_ext(d.name)
                except KeyError as e:
                    raise _err(self.src, d.loc, str(e)) from None
                self.ctx.exts[d.name] = fn
                self.ext_sigs[d.name] = d   # aliases ctx.ext_sigs
            elif isinstance(d, A.DLet):
                v = E.eval_expr(d.e, self.gscope, self.ctx)
                self.gscope.declare(d.name, v, None, mutable=False)
            elif isinstance(d, A.DFunComp):
                self.comp_funs[d.name] = d
            elif isinstance(d, A.DLetComp):
                self.top_comp_asts[d.name] = d.c
            else:
                raise _err(self.src, d.loc,
                           f"unknown declaration {type(d).__name__}")
        return self

    def build(self, entry: str = "main",
              typecheck: bool = True) -> CompiledProgram:
        self.elaborate()
        if typecheck:
            # static expression typechecker (reference TcExpr/TcUnify
            # role, SURVEY.md §2.1): dtype + array-length checking over
            # the surface AST with located errors, before any closure
            # can fail at runtime
            from ziria_tpu_torch.frontend.typecheck import check_program
            check_program(self)
        # elaborate non-entry top comps first, in order, so entry can
        # reference them
        base = ElabEnv(self.gscope)
        for name, cast in self.top_comp_asts.items():
            if name == entry:
                continue
            body, _, _ = self._split_io(cast)
            self.top_comps[name] = localize(self.elab_comp(body, base))
        if entry in self.top_comp_asts:
            cast = self.top_comp_asts[entry]
        elif entry in self.comp_funs and not self.comp_funs[entry].params:
            cast = self.comp_funs[entry].body
        else:
            known = sorted(set(self.top_comp_asts) | set(self.comp_funs))
            raise ElabError(
                f"{self.src}: no computation {entry!r} "
                f"(have: {', '.join(known) or 'none'}) — define "
                f"`let comp main = ...`")
        body, in_ty, out_ty = self._split_io(cast)
        comp = localize(self.elab_comp(body, base))
        fxp = self.ctx.fxp_complex16
        comp, in_name = _input_adapter(comp, in_ty, self.src, fxp)
        comp, out_name = _output_adapter(comp, out_ty, self.src, fxp)
        if typecheck:
            # stream-level discipline + item-dtype unification on the
            # final IR (core/types.py — the reference's TcComp/TcUnify
            # composition rules)
            from ziria_tpu_torch.core.types import ZiriaTypeError as StreamTE
            from ziria_tpu_torch.core.types import typecheck as stream_tc
            try:
                stream_tc(comp)
            except StreamTE as e:
                raise ElabError(f"{self.src}: {e}") from None
        return CompiledProgram(comp, in_name, out_name, entry,
                               dict(self.top_comps))

    def _split_io(self, c: A.Comp):
        """Strip CRead/CWrite off the ends of the top-level pipe chain."""
        segs: List[Tuple[A.Comp, bool]] = []   # (comp, par_with_next)

        def flatten(x: A.Comp, par_after: bool):
            if isinstance(x, A.CPipe):
                flatten(x.up, x.par)
                flatten(x.down, par_after)
            else:
                segs.append((x, par_after))

        flatten(c, False)
        in_ty = out_ty = None
        if segs and isinstance(segs[0][0], A.CRead):
            in_ty = segs[0][0].ty
            segs = segs[1:]
        if segs and isinstance(segs[-1][0], A.CWrite):
            out_ty = segs[-1][0].ty
            segs = segs[:-1]
        for s, _ in segs:
            if isinstance(s, (A.CRead, A.CWrite)):
                raise _err(self.src, s.loc,
                           "read/write only at pipeline ends")
        if not segs:
            raise _err(self.src, getattr(c, "loc", (0, 0)),
                       "pipeline has no computation between read and write")
        # rebuild left-assoc chain preserving par flags
        cur: A.Comp = segs[0][0]
        for k in range(1, len(segs)):
            cur = A.CPipe(getattr(segs[k][0], "loc", (0, 0)), cur,
                          segs[k][0], par=segs[k - 1][1])
        return cur, in_ty, out_ty


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _is_pure(e: A.Expr) -> bool:
    """Pre-evaluating at elaboration is only sound for call-free
    expressions (a user fun could print or error)."""
    if isinstance(e, A.ECall):
        return e.name in E._BASE_TYPE_NAMES and all(
            _is_pure(a) for a in e.args)
    kids: List[A.Expr] = []
    if isinstance(e, A.EUn):
        kids = [e.e]
    elif isinstance(e, A.EBin):
        kids = [e.a, e.b]
    elif isinstance(e, A.ECond):
        kids = [e.c, e.a, e.b]
    elif isinstance(e, A.EIdx):
        kids = [e.arr, e.i]
    elif isinstance(e, A.ESlice):
        kids = [e.arr, e.i, e.n]
    elif isinstance(e, A.EField):
        kids = [e.e]
    elif isinstance(e, A.EArrLit):
        kids = list(e.elems)
    elif isinstance(e, A.EStructLit):
        kids = [a for _, a in e.fields]
    return all(_is_pure(k) for k in kids if k is not None)


def _dtype_of(ty: Optional[A.Ty], fxp: bool = False) -> Optional[str]:
    """Numpy dtype name of a surface type's items (arrays use the
    element type), feeding Map dtype hints for the stream typechecker.
    Under the fixed-point policy complex16 items are int32 pairs."""
    t = ty.elem if isinstance(ty, A.TArr) else ty
    if not isinstance(t, A.TBase):
        return None
    if fxp and t.name == "complex16":
        return "int32"
    try:
        return str(np.dtype(E.base_dtype(t.name)))
    except Exception:
        return None


def _domain_of(ty: Optional[A.Ty]) -> Optional[int]:
    """AutoLUT input domain for small scalar types (SURVEY.md §2.1)."""
    if isinstance(ty, A.TBase):
        if ty.name in ("bit", "bool"):
            return 2
        if ty.name == "int8":
            return 256
    return None


def _device_init(init: Any, ty: A.Ty) -> Any:
    """Force var-decl initializers to concrete array values with the
    declared dtype, so MapAccum carries keep a stable dtype under scan.

    numpy (not torch): the jit backend converts carries at its stage
    boundary, while the interpreter keeps evaluating stream-level vars
    on the numpy fast path (eval._np_ok). Device initializers (closures
    over a device env) still yield tensors via eval's own dispatch."""
    if callable(init):
        def run(env, _i=init, _ty=ty):
            return _to_arr(_i(env), _ty)
        return run
    return _to_arr(init, ty)


def _to_arr(v: Any, ty: A.Ty):
    if isinstance(v, dict):
        return v
    if not E._np_ok(v):
        return E._t(v)
    if E.is_static(v) and isinstance(ty, A.TBase):
        return np.asarray(v, E.base_dtype(ty.name))
    return np.asarray(v)


def _input_adapter(comp: ir.Comp, ty: Optional[A.Ty], src: str,
                   fxp: bool = False):
    if ty is None:
        return comp, None
    name = _file_ty(ty, src)
    if fxp and name == "complex16":
        # fixed-point policy: items stay integer IQ pairs on the wire
        # AND in the program — just widen storage to int32 so C-style
        # promotion holds mid-expression
        def to_fx(p):
            if E._np_ok(p):
                return np.asarray(p, np.int32)
            return E._t(p).to(torch.int32)

        return ir.Pipe(ir.Map(to_fx, name="iq_to_fx", in_dtype="int16",
                              out_dtype="int32"), comp), name
    if name in ("complex16", "complex32"):
        def to_c64(p):
            # numpy for host items (the interpreter's per-sample loop),
            # torch for the jit backend's device items
            if E._np_ok(p):
                p = np.asarray(p, np.float32)
                return (p[0] + 1j * p[1]).astype(np.complex64)
            p = E._t(p).to(torch.float32)
            return torch.complex(p[..., 0], p[..., 1])

        return ir.Pipe(ir.Map(to_c64, name="iq_to_c64",
                              in_dtype="int16", out_dtype="complex64"),
                       comp), name
    return comp, name


def _output_adapter(comp: ir.Comp, ty: Optional[A.Ty], src: str,
                    fxp: bool = False):
    if ty is None:
        return comp, None
    name = _file_ty(ty, src)
    if fxp and name == "complex16":
        def fx_to_iq(z):
            # wrap to int16 exactly as a complex16 store does; accepts
            # f32/c64 values too (rounded) for mixed f32 blocks (FFT)
            if E._np_ok(z):
                a = np.asarray(z)
                if np.dtype(a.dtype).kind == "c":
                    a = np.stack([np.round(np.real(a)),
                                  np.round(np.imag(a))], axis=-1)
                return E.fx_wrap16(a).astype(np.int16)
            a = E._t(z)
            if a.is_complex():
                a = torch.stack([torch.round(a.real), torch.round(a.imag)],
                                dim=-1)
            return E.fx_wrap16(a).to(torch.int16)

        # no in_dtype hint: this adapter deliberately accepts BOTH
        # int32 pairs and complex64 values (mixed f32 blocks), so a
        # concrete hint would reject the complex case it supports
        return ir.Pipe(comp, ir.Map(fx_to_iq, name="fx_to_iq",
                                     out_dtype="int16")), name
    if name in ("complex16", "complex32"):
        dt = np.int16 if name == "complex16" else np.int32

        def to_iq(z, _dt=dt):
            if E._np_ok(z):
                z = np.asarray(z, np.complex64)
                return np.stack([np.round(z.real),
                                 np.round(z.imag)]).astype(_dt)
            z = E._t(z).to(torch.complex64)
            return torch.stack([torch.round(z.real), torch.round(z.imag)],
                               dim=-1).to(E.t_dtype(_dt))

        return ir.Pipe(comp, ir.Map(to_iq, name="c64_to_iq",
                                     in_dtype="complex64",
                                     out_dtype=("int16" if dt is np.int16
                                                else "int32"))), name
    return comp, name


def _file_ty(ty: A.Ty, src: str) -> str:
    if isinstance(ty, A.TBase) and ty.name in _FILE_TY:
        return _FILE_TY[ty.name]
    raise ElabError(f"{src}: stream item type {ty} has no file "
                    f"representation (use bit/int*/double/complex16/32)")


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


_INCLUDE_RE = re.compile(
    r'^\s*#\s*include\s+"([^"]+)"\s*(--.*)?$')


def _load_program(src: str, src_name: str, base_dir: Optional[str],
                  seen: set) -> A.Program:
    """Parse `src` after resolving top-level `#include "path"` lines.

    The reference's programs compose via the C preprocessor — tx.blk
    pulls in the per-block files and lib/ ext declarations (SURVEY.md
    §2.3). Here includes resolve at the DECLARATION level: each
    include line is blanked in place (host line numbers stay exact),
    the included file is parsed with its OWN src_name (parse errors
    are file-accurate; type/elab/runtime diagnostics cite the host
    program's name with the included file's line numbers — Loc is
    (line, col) program-wide), and its declarations are prepended in
    include order, so a host declaration of the same name (e.g.
    `main`) overrides a library's. Paths are relative to the
    including file; each resolved path is included once per program
    (pragma-once semantics — mutual includes terminate)."""
    lines = src.split("\n")
    pre: List[A.Decl] = []
    for i, ln in enumerate(lines):
        m = _INCLUDE_RE.match(ln)
        if m is None:
            continue
        if base_dir is None:
            raise ElabError(
                f"{src_name}:{i + 1}:1: #include requires a file-based "
                f"compile (compile_file) so relative paths resolve")
        inc = os.path.normpath(os.path.join(base_dir, m.group(1)))
        lines[i] = ""
        if inc in seen:
            continue
        seen.add(inc)
        try:
            with open(inc, "r") as fh:
                inc_src = fh.read()
        except OSError as e:
            raise ElabError(
                f"{src_name}:{i + 1}:1: cannot include "
                f"{m.group(1)!r}: {e}") from None
        pre.extend(_load_program(inc_src, inc,
                                 os.path.dirname(inc), seen).decls)
    prog = parse_program("\n".join(lines), src_name)
    return A.Program(tuple(pre) + tuple(prog.decls))


def compile_source(src: str, src_name: str = "<input>",
                   entry: str = "main", typecheck: bool = True,
                   fxp_complex16: bool = False,
                   autolut: bool = False,
                   base_dir: Optional[str] = None) -> CompiledProgram:
    # seed `seen` with the root file itself so an include cycle back
    # to the host cannot re-parse it and duplicate its declarations
    seen = set()
    if base_dir is not None:
        seen.add(os.path.normpath(os.path.abspath(src_name)))
    prog = _load_program(src, src_name, base_dir, seen)
    return Elaborator(prog, src_name, fxp_complex16=fxp_complex16,
                      autolut=autolut) \
        .build(entry, typecheck=typecheck)


def compile_file(path: str, entry: str = "main", typecheck: bool = True,
                 fxp_complex16: bool = False,
                 autolut: bool = False) -> CompiledProgram:
    with open(path, "r") as fh:
        return compile_source(fh.read(), path, entry,
                              typecheck=typecheck,
                              fxp_complex16=fxp_complex16,
                              autolut=autolut,
                              base_dir=os.path.dirname(
                                  os.path.abspath(path)))
