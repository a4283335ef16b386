"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel package dispatches on the device of its tensors: a CUDA
tensor launches the kernel, which either runs or raises; a CPU tensor
takes the plain version. There is no fallback on the card.
"""
from __future__ import annotations

import torch


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """Whether ``t`` goes to ``what``'s kernel (CUDA) or to its plain
    version (CPU); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on CUDA or CPU tensors, got {t.device}")
