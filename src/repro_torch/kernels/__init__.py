"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel package dispatches on the device of its tensors: a CUDA
tensor launches the kernel, which either runs or raises; a CPU tensor
takes the plain version. There is no fallback on the card. A meta tensor
(``repro_torch.launch.dryrun``'s passes, which allocate nothing) takes
the plain version too: on meta it computes only shapes, so a kernel's
work is counted as its plain version's, and nothing is built or
launched.
"""
from __future__ import annotations

import torch


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """Whether ``t`` goes to ``what``'s kernel (CUDA) or to its plain
    version (CPU, or meta); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what} runs on CUDA, CPU or meta tensors, got "
                     f"{t.device}")
