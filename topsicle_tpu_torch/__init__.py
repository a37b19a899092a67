"""topsicle-tpu on PyTorch and CUDA: the telomere-boundary engine ported
to an NVIDIA H100.

The JAX package (`topsicle_tpu`) stays the reference; this package
stands on its own and imports nothing of it, and never jax.  Its host
half (config, k-mer tables, IO, the native reader, the oracle,
aggregates, manifest, prefetch, plots) is its own copy of the
reference's framework-free modules, under the same relative names:

    topsicle_tpu_torch.config    TopsicleConfig
    topsicle_tpu_torch.kmers     k-mer tables and base codes
    topsicle_tpu_torch.io        readers, batch assembly, writers, block cache
    topsicle_tpu_torch.native    the C++ reader (native/tsio.cc, built at
                                 first use into the compile cache)
    topsicle_tpu_torch.oracle    the pure-Python reference semantics
    topsicle_tpu_torch.utils     manifest, prefetch, the span and counter
                                 recorder (StageTimers), the
                                 compile cache (TOPSICLE_COMPILE_CACHE,
                                 else _build/)
    topsicle_tpu_torch.plots     matplotlib figures (optional import)
    topsicle_tpu_torch.device    explicit device choice (cuda | cpu)
    topsicle_tpu_torch.ops       plain torch ops + the hand-written CUDA
                                 kernels (csrc/)
    topsicle_tpu_torch.models    TorchScanModel, the engine's device API,
                                 and the host model for k > 15
    topsicle_tpu_torch.parallel  several cards (ShardedScanModel) and
                                 processes (files mode, --shardMode global)
    topsicle_tpu_torch.pipeline  TorchEngine and make_engine
    topsicle_tpu_torch.cli       `topsicle-torch`, the reference CLI + --device
    topsicle_tpu_torch.plot_cli  `topsicle-torch-overview`
"""

__version__ = "0.1.0"

from topsicle_tpu_torch.config import TopsicleConfig  # noqa: F401
