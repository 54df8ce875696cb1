"""Meshes and the parallel axes of the port (counterpart of
ziria_tpu/parallel): frame batching (dp), stage pipelining (pp) and
stream splitting (sp) over a mesh of device entries driven by one
process (``mesh.py``), with ``torch.distributed`` for several
processes (``multihost.py``)."""

from ziria_tpu_torch.parallel.autosplit import (AutoSplitError,
                                                auto_pipeline,
                                                balanced_partition)
from ziria_tpu_torch.parallel.batch import (data_parallel, frame_mesh,
                                            shard_batch)
from ziria_tpu_torch.parallel.multihost import (build_mesh, init_multihost,
                                                mesh_info)
from ziria_tpu_torch.parallel.stages import PPLowered, lower_stage_parallel
from ziria_tpu_torch.parallel.streampar import (StreamParError,
                                                sliding_parallel,
                                                stream_mesh,
                                                stream_parallel,
                                                stream_parallel_batched)

__all__ = [
    "AutoSplitError",
    "PPLowered",
    "StreamParError",
    "auto_pipeline",
    "balanced_partition",
    "build_mesh",
    "data_parallel",
    "frame_mesh",
    "init_multihost",
    "lower_stage_parallel",
    "mesh_info",
    "shard_batch",
    "sliding_parallel",
    "stream_mesh",
    "stream_parallel",
    "stream_parallel_batched",
]
