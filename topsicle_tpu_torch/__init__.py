"""topsicle-tpu on PyTorch and CUDA: the telomere-boundary engine ported
to an NVIDIA H100.

The JAX package (`topsicle_tpu`) stays the reference.  This package
reuses its framework-free host half (config, k-mer tables, IO, the
native reader, the oracle, aggregates, manifest, prefetch) and replaces
only what touches JAX:

    topsicle_tpu_torch.device    explicit device choice (cuda | cpu)
    topsicle_tpu_torch.ops       plain torch ops + the hand-written CUDA
                                 step-2 sum-signal kernel (csrc/)
    topsicle_tpu_torch.models    TorchScanModel, the engine's device API
    topsicle_tpu_torch.pipeline  TorchEngine, a jax-free run loop
    topsicle_tpu_torch.cli       `topsicle-torch`, the reference CLI + --device

Nothing here imports jax, directly or through topsicle_tpu.ops/models/
parallel: the machine with the card has no jax.
"""

__version__ = "0.1.0"

from topsicle_tpu.config import TopsicleConfig  # noqa: F401
