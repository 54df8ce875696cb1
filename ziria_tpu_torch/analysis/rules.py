"""Lint rules, retargeted to the port (counterpart of
ziria_tpu/analysis/rules.py).

  R1  cache-key completeness: the reference's check that a knob read
      inside an ``@lru_cache`` jit factory is part of its compile-cache
      key. Eager torch compiles no program per key, so the rule has no
      counterpart and is not run (``NOT_RUN``; ``--list-rules`` says so).
  R2  host sync in a hot path: ``.item()``, ``.cpu()``, ``.tolist()``,
      ``.numpy()``, ``torch.cuda.synchronize()`` and ``float()`` /
      ``int()`` / ``bool()`` of a tensor inside a ``dispatch.timed()``
      region make a device wait count as dispatch time.
  R3  untimed launch: a launch of the port's kernel wrappers
      (``ops/viterbi_cuda``, ``ops/viterbi_fused``) or a chunk-machine
      step (``backend/chunked``) outside ``dispatch.timed()`` is
      invisible to the per-site counters and traces.
  R4  env-read hygiene: ``os.environ`` read at import time, or outside
      a designated single-reader function; any environment write
      outside one.
  R5  cache hygiene: ``lru_cache`` keyed on (or closing over) tensors
      or arrays.
  R6  geometry hygiene: a numeric literal for a known tunable passed as
      a keyword argument, or a literal ``pow2_bucket`` floor, bypasses
      ``utils/geometry.Geometry`` (whose module holds the defaults).

The designated env readers are a naming convention: ``*_enabled`` /
``*_mode`` / ``env_*`` / ``_check_*``.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from ziria_tpu_torch.analysis.engine import (ENV_WRITE_METHODS, Context,
                                             Rule, env_write_target,
                                             in_timed_block, is_env_read,
                                             is_lru_cached, qual_name)

#: designated env single-readers (matched on the last dotted
#: component, leading underscores stripped)
DESIGNATED_READER = re.compile(r"(_enabled$|_mode$|^env_|^check_)")

#: reference rules with no counterpart in the port, and why
NOT_RUN = {
    "R1": ("cache-key-completeness: no counterpart; eager torch "
           "compiles no program per cache key, so no knob can miss one "
           "(not run)"),
}

SYNC_BUILTINS = ("float", "int", "bool")
SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
ARRAY_ANNOTATIONS = re.compile(r"(ndarray|Tensor)")

#: the kernel wrappers that launch a hand-written kernel on a CUDA
#: tensor, by module
LAUNCHERS = {
    "viterbi_cuda": frozenset({
        "acs", "acs_with_stops", "traceback", "viterbi_decode_batch",
        "viterbi_decode_batch_opt", "viterbi_decode_batch_windowed"}),
    "viterbi_fused": frozenset({
        "fused_acs_mixed", "fused_acs_mixed_with_stops",
        "viterbi_decode_mixed_fused", "fused_acs_rate",
        "fused_acs_rate_with_stops", "viterbi_decode_batch_fused"}),
}


def _functions(tree: ast.AST) -> List[ast.AST]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _tensor_names(fn: ast.AST) -> Set[str]:
    """Names in ``fn`` assigned from a ``torch.*`` call or a tensor
    method producing a tensor (``.to``/``.cuda``/``.clone``): the
    values R2 treats as device tensors."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        q = qual_name(node.value.func)
        f = node.value.func
        if not (q.startswith("torch.") or (
                isinstance(f, ast.Attribute)
                and f.attr in ("to", "cuda", "clone", "contiguous"))):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                out.update(e.id for e in t.elts
                           if isinstance(e, ast.Name))
    return out


class HostSyncInHotPath(Rule):
    id = "R2"
    name = "host-sync-in-hot-path"
    why = ("a host sync inside a dispatch.timed() region blocks on the "
           "device there, so the site's latency reports device wait as "
           "dispatch time")

    def check(self, ctx: Context) -> None:
        mod = ctx.module
        tensors: dict = {}          # enclosing function -> tensor names
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    not self._sync_shaped(node) or \
                    not in_timed_block(mod, node):
                continue
            chain = mod.enclosing_functions(node)
            fn = chain[0] if chain else mod.tree
            if fn not in tensors:
                tensors[fn] = _tensor_names(fn)
            sync = self._sync_target(node, tensors[fn])
            if sync is not None:
                ctx.report(node, (
                    f"host sync '{sync}' inside a dispatch.timed() "
                    f"region: move it out of the timed block so the "
                    f"site times the launch, not the device wait"))

    @staticmethod
    def _sync_shaped(call: ast.Call) -> bool:
        f = call.func
        return (isinstance(f, ast.Name) and f.id in SYNC_BUILTINS) or (
            isinstance(f, ast.Attribute)
            and (f.attr in SYNC_METHODS or f.attr == "synchronize"))

    @staticmethod
    def _sync_target(call: ast.Call, tensors: Set[str]) -> Optional[str]:
        def is_tensor(e: ast.AST) -> bool:
            if isinstance(e, ast.Name):
                return e.id in tensors
            if isinstance(e, (ast.Subscript, ast.Attribute)):
                return is_tensor(e.value)
            if isinstance(e, ast.Call):
                return qual_name(e.func).startswith("torch.")
            return False

        f = call.func
        q = qual_name(f)
        if q.endswith("cuda.synchronize"):
            return q + "()"
        if isinstance(f, ast.Name) and f.id in SYNC_BUILTINS and \
                call.args and is_tensor(call.args[0]):
            return f.id
        if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
            # .cpu() and .numpy() exist on tensors only; .item() and
            # .tolist() also on numpy values, so those need a tensor
            if f.attr in ("cpu", "numpy") or is_tensor(f.value):
                return f".{f.attr}()"
        return None


def _launcher_aliases(tree: ast.Module):
    """(module aliases -> wrapper names, directly imported wrappers):
    how this file can name the kernel wrappers."""
    mods, direct = {}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            last = node.module.rsplit(".", 1)[-1]
            for a in node.names:
                if a.name in LAUNCHERS:
                    mods[a.asname or a.name] = LAUNCHERS[a.name]
                elif last in LAUNCHERS and a.name in LAUNCHERS[last]:
                    direct.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                last = a.name.rsplit(".", 1)[-1]
                if last in LAUNCHERS and a.asname:
                    mods[a.asname] = LAUNCHERS[last]
    return mods, direct


def _launch_name(call: ast.Call, mods, direct) -> Optional[str]:
    """The launch `call` makes, if any: a kernel wrapper, or a chunk
    machine's ``run`` (``..._machines[key].run(...)``)."""
    f = call.func
    if isinstance(f, ast.Name) and f.id in direct:
        return f.id
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id in mods \
                and f.attr in mods[f.value.id]:
            return f"{f.value.id}.{f.attr}"
        if f.attr == "run" and isinstance(f.value, ast.Subscript) and \
                qual_name(f.value.value).endswith("_machines"):
            return "chunk-machine step"
    return None


class UntimedLaunch(Rule):
    id = "R3"
    name = "untimed-launch"
    why = ("a kernel-wrapper launch or a chunk-machine step outside "
           "dispatch.timed() is invisible to the telemetry layer: no "
           "per-site latency, no dispatch counter, no trace span")

    def check(self, ctx: Context) -> None:
        mod = ctx.module
        base = mod.path.replace("\\", "/").rsplit("/", 1)[-1][:-3]
        if base in LAUNCHERS:
            return         # the wrappers themselves, and their helpers
        mods, direct = _launcher_aliases(mod.tree)
        machines = self._machine_locals(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _launch_name(node, mods, direct)
            f = node.func
            if name is None and isinstance(f, ast.Attribute) and \
                    f.attr == "run" and isinstance(f.value, ast.Name) \
                    and f.value.id in machines:
                name = "chunk-machine step"
            if name is not None and not in_timed_block(mod, node):
                ctx.report(node, (
                    f"'{name}' launched outside dispatch.timed(): wrap "
                    f"the call site so its latency and count are "
                    f"observable"))

    @staticmethod
    def _machine_locals(tree: ast.Module) -> Set[str]:
        """Names bound to ``..._machines[key]``."""
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Subscript) and \
                    qual_name(node.value.value).endswith("_machines"):
                out.update(t.id for t in node.targets
                           if isinstance(t, ast.Name))
        return out


class EnvReadHygiene(Rule):
    id = "R4"
    name = "env-read-hygiene"
    why = ("an env read at import time (or scattered outside a "
           "designated *_enabled/*_mode/env_* single reader) escapes "
           "the cli scoped-env pattern: the flag stops being "
           "overridable per invocation, and two readers can disagree")

    def check(self, ctx: Context) -> None:
        mod = ctx.module
        for node in ast.walk(mod.tree):
            w = env_write_target(node)
            if w is not None:
                ctx.report(w, (
                    "environment write outside the cli scoped-env "
                    "pattern: mutate os.environ only through a "
                    "scoped write+restore (runtime/cli.main)"))
                continue
            if not is_env_read(node):
                continue
            # a write's environ mention is reported above, once
            par = mod.parent_of(node)
            if isinstance(par, ast.Attribute) and \
                    par.attr in ENV_WRITE_SKIP:
                continue
            if isinstance(par, ast.Subscript) and \
                    not isinstance(par.ctx, ast.Load):
                continue       # os.environ[k] = / del: the write rule
            chain = mod.enclosing_functions(node)
            if not chain:
                ctx.report(node, (
                    "env read at import time: module import order "
                    "decides the value and the cli scoped-env "
                    "pattern cannot override it; read at call time "
                    "inside a designated single-reader function"))
            elif not any(DESIGNATED_READER.search(
                    f.name.lstrip("_")) for f in chain):
                ctx.report(node, (
                    f"env read inside "
                    f"'{chain[0].name}', which is not a designated "
                    f"single-reader (*_enabled / *_mode / env_* / "
                    f"_check_*): hoist the read into ONE reader "
                    f"function so every surface agrees on the knob"))


#: attribute accesses on environ that the write check reports — the
#: read check must not double-report their `environ` mention
ENV_WRITE_SKIP = set(ENV_WRITE_METHODS)


class CacheHygiene(Rule):
    id = "R5"
    name = "cache-hygiene"
    why = ("lru_cache keyed on (or closing over) tensors or arrays is a "
           "leak: such keys are unhashable or compare by id, so the "
           "cache grows per call and pins device buffers forever")

    def check(self, ctx: Context) -> None:
        mod = ctx.module
        cached = [n for n in _functions(mod.tree) if is_lru_cached(n)]
        cached_names = {n.name for n in cached}
        for fn in cached:
            for p in fn.args.posonlyargs + fn.args.args \
                    + fn.args.kwonlyargs:
                ann = p.annotation
                if ann is not None and ARRAY_ANNOTATIONS.search(
                        ast.unparse(ann)):
                    ctx.report(p, (
                        f"lru_cache'd '{fn.name}' takes array-typed "
                        f"parameter '{p.arg}': arrays are not hashable "
                        f"cache keys — key on shape/dtype/mode "
                        f"scalars and pass the array to the returned "
                        f"callable"))
            if any(isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for a in mod.ancestors(fn)):
                ctx.report(fn, (
                    f"lru_cache'd '{fn.name}' is defined inside "
                    f"another function: every outer call makes a NEW "
                    f"cache closing over that call's locals (arrays "
                    f"included) — hoist the cached def to module "
                    f"scope"))
        # call-site check: obviously-array arguments to a cached
        # function defined in this module
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if qual_name(node.func).rsplit(".", 1)[-1] \
                    not in cached_names:
                continue
            for a in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(a, ast.Call):
                    q = qual_name(a.func)
                    if q.rsplit(".", 1)[-1] in (
                            "asarray", "array", "tensor", "from_numpy",
                            "as_tensor") and q.split(".", 1)[0] in (
                            "np", "numpy", "torch"):
                        ctx.report(a, (
                            f"array argument "
                            f"'{ast.unparse(a)[:40]}' keys the "
                            f"lru_cache of "
                            f"'{qual_name(node.func)}': the cache "
                            f"grows one entry per array object"))


#: tunable names R6 refuses as literal keyword arguments — each has one
#: home on the Geometry dataclass, and a literal elsewhere silently
#: forks the geometry the autotuner tunes
KNOWN_TUNABLES = frozenset({
    "chunk_len", "frame_len", "max_frames_per_chunk", "n_streams",
    "viterbi_window", "viterbi_radix", "min_bucket",
})


def _is_numeric_literal(node: ast.AST) -> bool:
    """A compile-time number: ``8192``, ``1 << 13``, ``-1``, or any
    BinOp/UnaryOp tree over such constants."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and \
            not isinstance(node.value, bool)
    if isinstance(node, ast.BinOp):
        return _is_numeric_literal(node.left) and \
            _is_numeric_literal(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_literal(node.operand)
    return False


class GeometryHygiene(Rule):
    id = "R6"
    name = "geometry-hygiene"
    why = ("a numeric literal for a known tunable at a call site (or a "
           "literal pow2_bucket floor) bypasses the Geometry object: "
           "the literal and Geometry's default can drift apart, and the "
           "autotuner's tuned() winner never reaches that surface")

    def check(self, ctx: Context) -> None:
        mod = ctx.module
        if mod.path.replace("\\", "/").endswith("utils/geometry.py"):
            return         # the defaults' one home
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = qual_name(node.func).rsplit(".", 1)[-1]
            if name == "pow2_bucket":
                floor = None
                if len(node.args) >= 2:
                    floor = node.args[1]
                for k in node.keywords:
                    if k.arg == "min_bucket":
                        floor = k.value
                if floor is not None and _is_numeric_literal(floor):
                    ctx.report(floor, (
                        "literal pow2_bucket floor "
                        f"'{ast.unparse(floor)}': bucket minimums live "
                        "on the Geometry object (sym_bucket / "
                        "capture_bucket / bit_bucket) — a literal here "
                        "forks the bucketing rule from the tuned "
                        "geometry"))
                continue
            for k in node.keywords:
                if k.arg in KNOWN_TUNABLES and \
                        _is_numeric_literal(k.value):
                    ctx.report(k.value, (
                        f"literal '{k.arg}={ast.unparse(k.value)}' at "
                        f"call site '{qual_name(node.func) or '<call>'}'"
                        f": thread the value from a Geometry "
                        f"(utils/geometry) so the call and the tuned "
                        f"geometry cannot disagree"))


ALL_RULES = (HostSyncInHotPath(), UntimedLaunch(), EnvReadHygiene(),
             CacheHygiene(), GeometryHygiene())

RULES_BY_ID = {r.id: r for r in ALL_RULES}
