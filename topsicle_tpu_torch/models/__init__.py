"""The torch device programs the engine calls."""

from topsicle_tpu_torch.models.state import state_from_jax  # noqa: F401
from topsicle_tpu_torch.models.telomere import TorchScanModel  # noqa: F401
