"""The one rule that turns a device request into a torch device, below
ops/, parallel/ and models/, which all take a `device`."""

from __future__ import annotations

import torch

from .errors import AcceleratorError


def resolve_device(device) -> torch.device:
    """torch.device for a device request. "cpu" and "cuda" (or any torch
    device of those types) are taken as they are; the JAX client's values
    are accepted too: False is the CPU, True is CUDA, "auto" is CUDA when
    there is a CUDA device and the CPU otherwise. The choice is made here,
    once, before any work: a CUDA request on a machine without CUDA raises
    instead of running on the CPU, and nothing that fails later falls back.
    Client.setup takes False, and "auto" without CUDA, as the JAX client's
    host engine before it calls this."""
    if device is False:
        device = "cpu"
    elif device is True:
        device = "cuda"
    elif isinstance(device, str) and device == "auto":
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise AcceleratorError(f"device {device} requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device} (cpu or cuda)")
    return device
