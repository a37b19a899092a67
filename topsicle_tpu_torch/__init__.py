"""topsicle-tpu on PyTorch and CUDA: the telomere-boundary engine ported
to an NVIDIA H100.

The JAX package (`topsicle_tpu`) stays the reference.  This package
reuses its framework-free host half (config, k-mer tables, IO, the
native reader, the oracle, aggregates, manifest, prefetch) and replaces
only what touches JAX:

    topsicle_tpu_torch.device    explicit device choice (cuda | cpu)
    topsicle_tpu_torch.ops       plain torch ops + the hand-written CUDA
                                 step-2 kernels (csrc/)
    topsicle_tpu_torch.models    TorchScanModel, the engine's device API,
                                 and the host model for k > 15
    topsicle_tpu_torch.parallel  several cards (ShardedScanModel) and
                                 processes (files mode, --shardMode global)
    topsicle_tpu_torch.pipeline  TorchEngine, a jax-free run loop
    topsicle_tpu_torch.cli       `topsicle-torch`, the reference CLI + --device

Nothing here imports jax, directly or through topsicle_tpu.ops/models/
parallel: the two framework-free files under those packages that the
port needs are loaded by path (_host.py).
"""

__version__ = "0.1.0"

from topsicle_tpu.config import TopsicleConfig  # noqa: F401
