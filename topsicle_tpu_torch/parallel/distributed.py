"""Files mode over several processes (--processId/--processCount).

Input files are dealt round-robin; each process writes each (phrase,
file) unit's CSV rows and full-precision aggregates to a part file under
{outputDir}/.parts/; process 0 waits for every process's done marker,
merges the parts in (phrase, file-index) order into a CSV byte-identical
to a single-process run's, and removes them.

The part files, markers and merge are topsicle_tpu/parallel/distributed.py
itself, loaded without its jax-importing package (see _host.py).  Only
the two functions that ask jax who the process is and wait for the
others are replaced here, by their torch.distributed counterparts.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch.distributed as dist

from topsicle_tpu_torch._host import load

_files = load("parallel/distributed.py")
my_files = _files.my_files
write_part = _files.write_part
reset_mine = _files.reset_mine
mark_done = _files.mark_done
wait_all = _files.wait_all
merge = _files.merge
cleanup_parts = _files.cleanup_parts

# The end-of-run barrier waits for the slowest process's whole share of
# the input, so it gets wait_all's day, not a collective's minutes.
BARRIER_TIMEOUT = datetime.timedelta(days=1)


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group, or (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_identity(process_id: Optional[int], process_count: Optional[int]
                     ) -> Tuple[int, int]:
    """Explicit overrides win; else the process group's rank and size."""
    if process_count is not None:
        return int(process_id or 0), int(process_count)
    return world()


def barrier() -> None:
    """Wait for every process of the group; a no-op without one (plain OS
    processes meet through mark_done/wait_all's file markers)."""
    if world()[1] > 1:
        dist.monitored_barrier(timeout=BARRIER_TIMEOUT)
