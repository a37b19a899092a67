"""More than one device or process: the counterpart of topsicle_tpu.parallel.

    mesh          local_devices (every visible card, or the CPU) and the
                  gloo process group (initialize_distributed)
    sharding      ShardedScanModel: one process's batches split by rows
                  over its devices, the kernels launched once per shard
    distributed   files mode: process identity, part files, done markers,
                  barrier and the process-0 merge
    multihost     --shardMode global: GlobalScanModel and the lockstep
                  control word (or_across_processes)
"""

from topsicle_tpu_torch.parallel.mesh import (initialize_distributed,  # noqa: F401
                                              local_devices)
from topsicle_tpu_torch.parallel.sharding import ShardedScanModel  # noqa: F401
