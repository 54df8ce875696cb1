"""Checkpoint/resume of pipeline stream state (counterpart of
ziria_tpu/runtime/state.py).

The reference has no persistence: component state lives in the
generated C global state struct for the life of the process
(SURVEY.md §5). Here that state is an explicit value: the carry
returned by ``backend.execute.run_jit_carry``, a dict of the per-stage
states (``"stages"``) plus the input items that did not yet fill a
steady-state iteration (``"leftover"``). Checkpointing is flatten +
save:

    ys1, carry = run_jit_carry(prog, first_half, device=dev)
    save_state("ckpt.npz", carry)
    ...process restarts...
    carry = load_state("ckpt.npz", like=lower(prog, device=dev).init_carry)
    ys2, carry = run_jit_carry(prog, second_half, carry=carry, device=dev)

`ys1 ++ ys2` equals the one-shot run for any split point (tested).
The template (`like`) restores the stage structure; leaf
count/shape/dtype mismatches are reported. Because two *different*
programs can share a state layout, callers may also pass
``fingerprint=program_fingerprint(comp)`` to both save and load: the
checkpoint then records which program wrote it and a mismatch is an
error. The CLI does this for --state-in/--state-out.

The carry is flattened by :func:`tree_leaves`, a walk of the port's own
in the order ``jax.tree.leaves`` takes: tuples and lists in order,
dicts by sorted key, None holds no leaf, anything else is one leaf. The
``.npz`` keys are the reference's (``n_leaves``, ``leaf{i}``,
``leftover``, ``fingerprint``).
"""

from __future__ import annotations

import hashlib
from typing import Any, List, Optional

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a carry: tuples and lists in order, dicts by
    sorted key, None none, anything else itself."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """`like`'s structure with its leaves replaced, in order, by
    `leaves` (a leaf that was a string in `like` comes back a string)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        v = next(it)
        return str(v) if isinstance(t, str) else v

    return build(like)


def _host(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def program_fingerprint(comp: Any) -> str:
    """A stable identity hash of a core-IR pipeline: node types, static
    counts/arities, bound names, stage function *code* and captured
    constants, enough to distinguish two programs whose state layouts
    happen to be identical, including two `zmap(lambda ...)` pipelines
    whose lambdas differ only in body.

    Deliberately excludes anything process-dependent (object addresses,
    dict order): the fingerprint must match across interpreter restarts
    or checkpoints would never load. It hashes the port's own bytecode,
    so it is not the reference's for the same program."""
    from ziria_tpu_torch.core import ir

    parts: list = []

    def add_callable(fn: Any, depth: int) -> None:
        code = getattr(fn, "__code__", None)
        parts.append(getattr(fn, "__qualname__",
                             getattr(fn, "__name__", "fn")))
        if code is None or depth > 6:
            return
        parts.append(hashlib.sha256(code.co_code).hexdigest()[:12])
        for const in code.co_consts:
            if isinstance(const, (int, float, bool, str, bytes)) \
                    or const is None:
                parts.append(repr(const))
        # captured cells carry the distinguishing data for the shared
        # elab closures (the `run` functions all have identical co_code;
        # the AST lives in their cells)
        for cell in (fn.__closure__ or ()):
            try:
                add_value(cell.cell_contents, depth + 1)
            except ValueError:
                pass
        for dflt in (fn.__defaults__ or ()):
            add_value(dflt, depth + 1)

    def add_value(v: Any, depth: int) -> None:
        if depth > 6:
            return
        if isinstance(v, ir.Comp):
            walk(v, depth)
        elif isinstance(v, (str, int, bool, float)) or v is None:
            parts.append(repr(v))
        elif isinstance(v, (list, tuple)):
            for it in v[:64]:
                add_value(it, depth + 1)
        elif callable(v):
            add_callable(v, depth)
        elif hasattr(v, "dtype"):
            a = _host(v)
            parts.append(f"arr{a.shape}{a.dtype}")
            # content hash for every captured array: a big LUT edited
            # between runs must change the fingerprint too
            parts.append(hashlib.sha256(
                np.ascontiguousarray(a).tobytes()).hexdigest()[:12])
        elif type(v).__module__.startswith("ziria_tpu_torch"):
            # AST / IR dataclasses: frozen plain-data nodes whose repr
            # is deterministic; guard against default object reprs,
            # whose addresses would make the fingerprint process-local
            r = repr(v)
            if " at 0x" not in r:
                parts.append(r[:4096])
            else:
                parts.append(type(v).__name__)

    def walk(x: Any, depth: int = 0) -> None:
        parts.append(type(x).__name__)
        d = getattr(x, "__dict__", None)
        if d is None or depth > 12:
            return
        for k in sorted(d):
            parts.append(k)
            add_value(d[k], depth + 1)
    walk(comp)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def save_state(path: str, carry: Any,
               fingerprint: Optional[str] = None) -> None:
    """Serialize a run_jit_carry carry (or bare stage states) to .npz."""
    if isinstance(carry, dict) and "stages" in carry:
        stages = carry["stages"]
        leftover = np.asarray(carry.get("leftover", np.empty(0)))
    else:
        stages, leftover = carry, np.empty(0)
    leaves = tree_leaves(stages)
    arrs = {f"leaf{i}": _host(v) for i, v in enumerate(leaves)}
    if fingerprint is not None:
        arrs["fingerprint"] = np.asarray(fingerprint)
    np.savez(path, n_leaves=np.int64(len(leaves)), leftover=leftover,
             **arrs)


def load_state(path: str, like: Any,
               fingerprint: Optional[str] = None) -> Any:
    """Load a carry saved by save_state, using `like` (the pipeline's
    ``lower(comp).init_carry``) as the stage-structure template. When
    both the file and the caller provide a program fingerprint, they
    must agree. Leaves come back as numpy arrays; run_jit_carry moves
    them to its device."""
    with np.load(path) as z:
        n = int(z["n_leaves"])
        leaves = [z[f"leaf{i}"] for i in range(n)]
        leftover = z["leftover"] if "leftover" in z else np.empty(0)
        saved_fp = (str(z["fingerprint"]) if "fingerprint" in z
                    else None)
    if fingerprint is not None and saved_fp is not None \
            and fingerprint != saved_fp:
        raise ValueError(
            f"checkpoint was written by a different program "
            f"(fingerprint {saved_fp} != {fingerprint}); refusing to "
            f"load it even though the state layout matches")
    template_leaves = tree_leaves(like)
    if len(template_leaves) != n:
        raise ValueError(
            f"checkpoint has {n} state leaves but the pipeline has "
            f"{len(template_leaves)}: wrong program for this checkpoint")
    for i, (a, b) in enumerate(zip(leaves, template_leaves)):
        b = _host(b)
        if np.shape(a) != b.shape:
            raise ValueError(
                f"state leaf {i} shape {np.shape(a)} does not match the "
                f"pipeline's {b.shape}: wrong program for this "
                f"checkpoint")
        if np.asarray(a).dtype != b.dtype:
            raise ValueError(
                f"state leaf {i} dtype {np.asarray(a).dtype} does not "
                f"match the pipeline's {b.dtype}: wrong program for "
                f"this checkpoint")
    return {"stages": tree_unflatten(like, leaves), "leftover": leftover}
