"""Frame batching across devices: the data-parallel axis (counterpart of
ziria_tpu/parallel/batch.py).

Independent frames split over a ``dp`` mesh axis: every entry runs its
shard of the leading (frame, lane or stream) axis, with no exchange
until the results are gathered. ``phy/link.sweep_ber_sharded`` and the
sharded ``MultiStreamReceiver`` ride this pattern. Meshes see the
devices of their kind (``parallel/mesh.visible_devices``): the cards
for ``device="cuda"``, 8 virtual entries for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ziria_tpu_torch.parallel.mesh import (Mesh, allgather_parts, gather,
                                           global_devices, process_rank,
                                           shard)


def frame_mesh(n_devices: Optional[int] = None, axis: str = "dp",
               device="cuda") -> Mesh:
    """A 1-D mesh over the first `n_devices` devices of `device`'s kind
    (all of them by default)."""
    devs = global_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, only {len(devs)} visible")
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def largest_divisor(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is <= ``cap``: the mesh width
    an S-lane fleet can use (the stream axis shards evenly). At least
    1."""
    if n < 1 or cap < 1:
        raise ValueError(f"need n >= 1 and cap >= 1, got ({n}, {cap})")
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def elastic_mesh(n_streams: int, n_devices: Optional[int] = None,
                 axis: str = "dp", device="cuda") -> Optional[Mesh]:
    """The widest dp mesh the visible devices of `device`'s kind (or
    `n_devices` of them) support for an ``n_streams``-lane receiver:
    the largest divisor of S that fits. None when that is one device
    (an unsharded receiver), so a machine with one card, or one that
    lost cards, runs the fleet on what is left."""
    vis = len(global_devices(device))
    avail = vis if n_devices is None else min(n_devices, vis)
    m = largest_divisor(n_streams, max(1, avail))
    return None if m <= 1 else frame_mesh(m, axis, device)


def lane_sharding(mesh: Mesh, ndim: int, axis: str = "dp"):
    """The one placement rule of every dp surface: the leading axis
    split over `axis`, everything else replicated. Returns the entries
    (devices, ranks) that own the shards; `ndim` is checked, as the
    reference's spec is built per rank."""
    if ndim < 1:
        raise ValueError("a sharded value needs a leading axis")
    return mesh.along(axis)


def shard_batch(mesh: Mesh, x, axis: str = "dp"):
    """`x` with its leading (frame) axis split over `axis`: one tensor a
    shard on its entry's device (None for another process's shard)."""
    return shard(x, mesh, axis)


def stream_specs(ndims, axis: str = "dp"):
    """One spec per rank in `ndims`: (axis, None, ...), axis 0 over
    `axis` and the rest replicated, the twin of :func:`lane_sharding`
    for callers that name a placement per argument."""
    return tuple((axis,) + (None,) * (int(n) - 1) for n in ndims)


def data_parallel(fn: Callable, mesh: Mesh, axis: str = "dp") -> Callable:
    """`fn` (batched: leading axis = frames) run with the frame axis of
    every argument split over `axis`: each of this process's entries
    runs `fn` on its shard, and the shards' results are gathered in
    order. On a mesh that spans processes the other processes' results
    come through ``torch.distributed`` (every process calls the
    returned function with the same global batch). Returns a tensor on
    the caller's device: the first argument's when it is a tensor, else
    the CPU."""
    devs, ranks = mesh.along(axis)
    me = process_rank()

    def run(*args):
        parts = [shard(a, mesh, axis) for a in args]
        out = {}
        for i, r in enumerate(ranks):
            if r == me:
                with torch.no_grad():
                    out[i] = fn(*[p[i] for p in parts])
        home = args[0].device if isinstance(args[0], torch.Tensor) \
            else torch.device("cpu")
        if mesh.spans_processes():
            host = {i: v.detach().cpu().numpy() for i, v in out.items()}
            got = allgather_parts(host, len(devs), mesh)
            return torch.from_numpy(np.concatenate(got)).to(home)
        return gather([out[i] for i in range(len(devs))], home)

    return run
