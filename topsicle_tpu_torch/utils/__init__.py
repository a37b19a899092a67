"""Runtime utilities: the span and counter recorder, run
manifest, bounded read-ahead, the compile cache of the native libraries
(compile_cache)."""

from topsicle_tpu_torch.utils.profiling import StageTimers, trace_context  # noqa: F401
from topsicle_tpu_torch.utils.manifest import RunManifest  # noqa: F401
