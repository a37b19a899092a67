"""Explicit device choice: the port never drifts to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """'cuda' -> the current CUDA device, 'cpu' -> the CPU (plain torch
    versions of every kernel).  Asking for 'cuda' without a card raises."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain torch versions")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (expected 'cuda' or 'cpu')")


def describe(device: torch.device) -> str:
    """One log line naming the device the run computes on."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)
