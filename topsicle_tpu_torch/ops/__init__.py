"""Device ops: plain torch (match, changepoint) and the hand-written CUDA
kernels (cuda_kernels).  All integer, so results are bit-identical across
the CPU, the card and the JAX reference."""

from topsicle_tpu_torch.ops import geometry  # noqa: F401
from topsicle_tpu_torch.ops.changepoint import binseg_l2_device  # noqa: F401
from topsicle_tpu_torch.ops.cuda_kernels import (  # noqa: F401
    binseg_l2,
    greedy_boundary,
    greedy_boundary_plain,
    greedy_counts,
    greedy_counts_plain,
    greedy_signal,
    greedy_signal_plain,
    step1_counts,
    step1_counts_plain,
    sum_boundary,
    sum_boundary_plain,
    sum_signal,
    sum_signal_plain,
)
from topsicle_tpu_torch.ops.match import (  # noqa: F401
    MAX_ROLLING_K,
    boundary_sum_signal,
    greedy_count,
    match_positions,
    num_windows,
    rolling_codes,
    unpack_codes,
    unpack_codes_len,
    unpack_wire,
    window_counts,
    window_signal,
)
