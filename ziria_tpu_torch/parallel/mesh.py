"""Device meshes for the port (what ``jax.sharding.Mesh``, ``shard_map``
and ``utils/compat.py`` give the reference).

The reference's mesh is one controller process driving every device of
an n-d array: the bodies of its ``shard_map`` programs are per-device
programs of that one process, and its tests give it 8 virtual CPU
devices. The port keeps that model. A :class:`Mesh` is an n-d array of
``torch.device`` entries with axis names, driven by the calling
process; an entry may name a device more than once (several shards on
one card, or on the CPU, are the counterpart of the reference tests'
virtual devices). Collectives become explicit copies and sums between
the shards' tensors: :func:`ppermute` and :func:`psum`. The shards of a
program run one after another in the calling process; no concurrency
is promised.

Each entry also carries the rank of the process that owns it. In one
process every entry is this process's; across processes
(``parallel/multihost.py``, over ``torch.distributed``) each process
runs only its own entries, and the few results that cross processes
go through ``torch.distributed`` (:func:`allgather_parts`,
:func:`allreduce_sum`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: the virtual CPU devices a mesh on ``device="cpu"`` sees: the count the
#: reference's tests give JAX (tests/conftest.py)
CPU_DEVICES = 8


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group (0 when no
    group is up)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def visible_devices(device="cuda") -> List[torch.device]:
    """The devices one process sees for a device kind: every CUDA card
    for ``cuda`` (raising when there is none), a fixed
    :data:`CPU_DEVICES` virtual entries for ``cpu``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    if kind != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu entries, not {kind!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "a mesh on cuda needs a CUDA device and none is available; "
            "build it with device='cpu' to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def global_devices(device="cuda") -> List[tuple]:
    """(rank, device) for every entry of every process, process-major:
    each process of the group sees :func:`visible_devices` of the same
    kind (the reference's ``jax.devices()``, global across processes)."""
    local = visible_devices(device)
    return [(r, d) for r in range(process_count()) for d in local]


def _is_pair(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], int)


def _entry(v):
    """(rank, torch.device) of a mesh entry given as a device, a device
    string or a (rank, device) pair; a bare device is this process's."""
    if _is_pair(v):
        return int(v[0]), torch.device(v[1])
    return process_rank(), torch.device(v)


def _nested(v):
    """(shape, entries) of a nested sequence (or numpy object array) of
    mesh entries."""
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if not isinstance(v, (list, tuple)) or _is_pair(v):
        return (), [v]
    subs = [_nested(x) for x in v]
    if len({shape for shape, _e in subs}) > 1:
        raise ValueError("a mesh's device array must not be ragged")
    inner = subs[0][0] if subs else ()
    return (len(v),) + inner, [e for _s, es in subs for e in es]


def _check_local(dev: torch.device) -> None:
    """Refuse a CUDA entry this process cannot reach."""
    if dev.type != "cuda":
        return
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            f"mesh entry {dev}: no CUDA device is available; build the "
            f"mesh on cpu entries to run on the CPU")
    if (dev.index or 0) >= n:
        raise RuntimeError(f"mesh entry {dev}: only {n} CUDA device(s) "
                           f"are visible")


class Mesh:
    """An n-d array of device entries with axis names.

    ``devices`` is a nested sequence (or numpy object array) of
    ``torch.device`` values, device strings or (rank, device) pairs;
    ``axis_names`` names its axes. ``shape`` is a dict (axis -> size),
    as the reference's ``mesh.shape[axis]``; ``size`` the entry count;
    ``devices`` the numpy object array of ``torch.device``; ``ranks``
    the owning process of each entry. A mesh hashes and compares by its
    layout. Every CUDA entry of this process must name a visible card."""

    def __init__(self, devices, axis_names: Sequence[str]):
        shape, entries = _nested(devices)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"a {len(shape)}-d device array needs "
                             f"{len(shape)} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        pairs = [_entry(v) for v in entries]
        me = process_rank()
        for r, d in pairs:
            if r == me:
                _check_local(d)
        self.devices = np.empty(len(pairs), dtype=object)
        self.devices[:] = [d for _r, d in pairs]
        self.devices = self.devices.reshape(shape)
        self.ranks = np.array([r for r, _d in pairs],
                              dtype=np.int64).reshape(shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.reshape(-1)),
                tuple(int(r) for r in self.ranks.reshape(-1)))

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")

    def axis_index(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: its axes are "
                             f"{self.axis_names}")
        return self.axis_names.index(axis)

    def grid(self, *axes: str):
        """(devices, ranks) with `axes` first, in that order, and every
        other axis taken at index 0: the entries that own each shard
        when the leading data axes split over `axes` and the rest is
        replicated (every replica computes the same values, so one
        computes them)."""
        idx = [self.axis_index(a) for a in axes]
        rest = [k for k in range(self.devices.ndim) if k not in idx]
        d = np.transpose(self.devices, idx + rest)
        r = np.transpose(self.ranks, idx + rest)
        cut = (Ellipsis,) if not rest else \
            tuple([slice(None)] * len(idx) + [0] * len(rest))
        return d[cut], r[cut]

    def along(self, axis: str):
        """(devices, ranks) of the entries that own the shards of a
        leading axis split over `axis` (:meth:`grid` of one axis)."""
        d, r = self.grid(axis)
        return list(d), [int(v) for v in r]

    def spans_processes(self) -> bool:
        return len(np.unique(self.ranks)) > 1

    def require_local(self, axis: str, why: str) -> None:
        """Refuse an axis whose entries belong to more than one process:
        its shards exchange data every step, which this process does
        between its own tensors only."""
        if np.any(np.diff(self.ranks, axis=self.axis_index(axis)) != 0):
            raise ValueError(
                f"mesh axis {axis!r} crosses processes (ranks "
                f"{sorted(set(int(r) for r in self.ranks.reshape(-1)))}): "
                f"{why}")

    def require_this_process(self, why: str) -> None:
        """Refuse a mesh with an entry of another process."""
        if (self.ranks != process_rank()).any():
            raise ValueError(
                f"the mesh has entries of other processes (ranks "
                f"{sorted(set(int(r) for r in self.ranks.reshape(-1)))}): "
                f"{why}")


def shard(x, mesh: Mesh, axis: str) -> List[Optional[torch.Tensor]]:
    """Split the leading axis of `x` (an array or a tensor) evenly over
    `axis`: one part per index along the axis, each on the device of
    the entry that owns it; parts owned by another process are None.
    The axis must divide the leading axis (``shard_batch``'s rule)."""
    devs, ranks = mesh.along(axis)
    n = len(devs)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(
            f"a leading axis of {tuple(x.shape)[:1] or '()'} does not "
            f"divide over the {n} entries of mesh axis {axis!r}")
    per = x.shape[0] // n
    me = process_rank()
    return [x[i * per:(i + 1) * per].to(d, non_blocking=True)
            if r == me else None for i, (d, r) in enumerate(zip(devs, ranks))]


def gather(parts, device=None) -> torch.Tensor:
    """Concatenate per-entry parts along their leading axis on the
    caller's `device` (default: the first part's)."""
    dev = torch.device(device) if device is not None else parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=0)


def ppermute(parts, perm, devices=None) -> list:
    """``lax.ppermute`` between shards: for each pair (i, j) of `perm`,
    part i copied to entry j's device (``devices[j]``, else part j's);
    an entry that no pair reaches gets zeros like its own part, and a
    part that is None (a shard with nothing this step) sends nothing."""
    out = [None if p is None else torch.zeros_like(p) for p in parts]
    for i, j in perm:
        src = parts[i]
        if src is None:
            out[j] = None
            continue
        dst = devices[j] if devices is not None else (
            parts[j].device if parts[j] is not None else src.device)
        out[j] = src.to(dst)
    return out


def psum(parts) -> torch.Tensor:
    """The exact sum of per-entry parts in their dtype (a bool part sums
    as int32 and comes back as bool), on the first part's device."""
    t0 = parts[0]
    acc = t0.to(torch.int32) if t0.dtype == torch.bool else t0.clone()
    for p in parts[1:]:
        acc += (p.to(torch.int32) if p.dtype == torch.bool else p).to(
            acc.device)
    return acc != 0 if t0.dtype == torch.bool else acc


def allgather_parts(local: Dict[int, object], n: int, mesh: Mesh) -> list:
    """The n parts of a sharded result in order, from this process's
    `local` parts ({index: picklable value}); on a mesh that spans
    processes the others' parts come through
    ``torch.distributed.all_gather_object``."""
    if mesh.spans_processes():
        import torch.distributed as dist
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, dict(local))
        merged = {}
        for g in got:
            merged.update(g)
        local = merged
    missing = [i for i in range(n) if i not in local]
    if missing:
        raise RuntimeError(f"parts {missing} of {n} were computed by no "
                           f"process of the mesh")
    return [local[i] for i in range(n)]


def allreduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` summed over the processes of `mesh` (exact for integers):
    ``torch.distributed.all_reduce`` on a mesh that spans processes,
    `t` itself otherwise. The tensor moves to the group backend's
    device kind for the reduction and back."""
    if not mesh.spans_processes():
        return t
    import torch.distributed as dist
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    buf = t.to(kind).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)
