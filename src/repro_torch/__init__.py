"""repro_torch — the PyTorch/CUDA port of ``repro`` (CODY on JAX).

It keeps the reference's module names (``models``, ``kernels``,
``training``, ``core``, ``obs``, ``serving``, ``launch``) and imports
neither JAX nor anything of ``repro``.  Its entry points run on the CUDA
device unless the caller asks for the CPU; a CUDA request on a machine
without a card raises instead of running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device is available; pass "
                           "device='cpu' to run the plain CPU path")
    return device


__all__ = ["resolve_device"]
