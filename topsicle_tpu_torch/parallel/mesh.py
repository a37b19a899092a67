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


def initialize_distributed(coordinator: Optional[str], num_processes: Optional[int],
                           process_id: Optional[int]) -> bool:
    """Join the gloo process group of `num_processes` processes whose
    rank 0 listens on `coordinator` (host:port); a no-op for one process.
    Returns whether a group was joined.  Gloo on the host carries only
    per-read records (a few kB per batch); the compute stays on the cards,
    and any number of processes may share one card."""
    if num_processes is None or num_processes <= 1:
        return False
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id or 0,
                            timeout=COLLECTIVE_TIMEOUT)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
