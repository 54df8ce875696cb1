"""Several processes: bring-up over ``torch.distributed`` and meshes
that know which process owns each entry (counterpart of
ziria_tpu/parallel/multihost.py).

The reference brings its processes up with ``jax.distributed`` and
lays its mesh out so that the axis with traffic every step stays
inside one host:

- ``pp`` (stage parallelism) moves a chunk between neighbouring stages
  every macro step, so it stays inside one process;
- ``dp`` (frame batching) exchanges nothing until the results are
  gathered, so it is the axis that may span processes.

Here ``torch.distributed`` is that bring-up (gloo for the CPU, NCCL for
the card), and :func:`build_mesh` keeps the same policy: dp process-
major and a multiple of the process count, pp inside each process.
Each process runs only its own entries; the dp gather and the sharded
sweep's error-count sum go through ``torch.distributed``
(``parallel/mesh.allgather_parts`` and ``allreduce_sum``).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ziria_tpu_torch.parallel.mesh import Mesh, _entry, global_devices


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   auto: bool = False, device="cuda",
                   timeout_s: Optional[float] = None, **kwargs) -> bool:
    """Bring up the process group (``torch.distributed``).

    Three modes:

    - no arguments: a no-op that returns False (one process never
      touches the backend);
    - ``auto=True``: ``env://``, the variables a launcher such as
      ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
    - an explicit coordinator ``host:port``, process count and rank:
      ``tcp://``.

    The backend is NCCL for ``device="cuda"`` and gloo for
    ``device="cpu"``; `timeout_s` bounds the bring-up and every later
    collective (``torch.distributed``'s own default otherwise). A
    coordinator that cannot be reached raises. Returns True once the
    group is up."""
    if not auto and num_processes in (None, 1) \
            and coordinator_address is None:
        return False
    import torch.distributed as dist
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if auto:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "init_multihost needs coordinator_address, num_processes "
                "and process_id together (or auto=True)")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id), **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return True


def shutdown_multihost() -> None:
    """Tear the process group down (a no-op when none is up)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def build_mesh(dp: int = 1, pp: int = 1,
               axis_names: Tuple[str, str] = ("dp", "pp"),
               devices: Optional[Sequence] = None,
               device="cuda") -> Mesh:
    """A (dp, pp) mesh of dp*pp entries: `devices` (devices, device
    strings or (rank, device) pairs) or every process's devices of
    `device`'s kind, first come first.

    Across processes, dp is process-major and must be a multiple of the
    process count; each process holds dp / n_processes rows of pp
    entries, so pp never leaves a process."""
    ents = [_entry(v) for v in devices] if devices is not None \
        else global_devices(device)
    n = dp * pp
    if len(ents) < n:
        raise ValueError(
            f"build_mesh(dp={dp}, pp={pp}) needs {n} devices; "
            f"{len(ents)} visible")
    ents = ents[:n]
    procs = sorted({r for r, _d in ents})
    if len(procs) > 1:
        n_proc = len(procs)
        if dp % n_proc:
            raise ValueError(
                f"dp={dp} must be a multiple of the process count "
                f"({n_proc}): dp is the axis that crosses processes; pp "
                f"must stay inside one process")
        rows = []
        for r in procs:
            mine = [e for e in ents if e[0] == r]
            if len(mine) != n // n_proc:
                raise ValueError(
                    f"process {r} holds {len(mine)} of the {n} entries; "
                    f"each process must hold dp/{n_proc} x pp = "
                    f"{n // n_proc}")
            rows += mine
        ents = rows
    return Mesh([ents[r * pp:(r + 1) * pp] for r in range(dp)], axis_names)


def mesh_info(mesh: Mesh) -> dict:
    """The layout: axis sizes, the number of processes, and which axes
    cross processes."""
    procs = mesh.ranks
    return {
        "shape": dict(mesh.shape),
        "n_processes": int(len(np.unique(procs))),
        "dcn_axes": [name for k, name in enumerate(mesh.axis_names)
                     if np.any(np.diff(procs, axis=k) != 0)],
    }
