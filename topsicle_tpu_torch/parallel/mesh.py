"""The devices a process computes on, and the process group of a
multi-process run."""

from __future__ import annotations

import datetime
from typing import List, Optional

import torch
import torch.distributed as dist

from topsicle_tpu_torch.device import resolve_device

# How long a collective (and the start-up rendezvous) may wait for the
# other processes before it raises: lockstep global mode meets every
# batch, so a peer that is this late has died or deadlocked.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def local_devices(kind: str) -> List[torch.device]:
    """'cuda' -> every card this process sees, as explicit cuda:0..n-1
    (a launcher picks a process's cards with CUDA_VISIBLE_DEVICES);
    'cpu' -> [cpu].  'cuda' without a card raises."""
    dev = resolve_device(kind)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


# The gloo group of global mode's result gathers, issued by
# multihost's gather thread; the control word keeps the default group.
_RESULT_GROUP: Optional[dist.ProcessGroup] = None


def initialize_distributed(coordinator: Optional[str], num_processes: Optional[int],
                           process_id: Optional[int]) -> bool:
    """Join the gloo process group of `num_processes` processes whose
    rank 0 listens on `coordinator` (host:port), and make the result
    group (`result_group`) with it; a no-op for one process.  Returns
    whether a group was joined.  Gloo on the host carries only per-read
    records (a few kB per batch); the compute stays on the cards, and any
    number of processes may share one card."""
    global _RESULT_GROUP
    if num_processes is None or num_processes <= 1:
        return False
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id or 0,
                            timeout=COLLECTIVE_TIMEOUT)
    # every process makes it here, in the same order: new_group is collective
    _RESULT_GROUP = dist.new_group(backend="gloo", timeout=COLLECTIVE_TIMEOUT)
    return True


def result_group() -> Optional[dist.ProcessGroup]:
    """The gloo group that carries global mode's result gathers, or None
    without a process group."""
    return _RESULT_GROUP


def shutdown_distributed() -> None:
    """Finish global mode's queued gathers and join their thread, then
    leave the process group, if this process joined one."""
    global _RESULT_GROUP
    from topsicle_tpu_torch.parallel.multihost import stop_gathers  # it imports this module

    stop_gathers()
    _RESULT_GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()
