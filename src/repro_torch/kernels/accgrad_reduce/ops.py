"""Public entry point of the AccGrad reduction.

A CUDA tensor launches the hand-written kernel (``kernel.py``), which
either runs or raises; a CPU tensor takes the plain PyTorch version
(``ref.py``). One frame (H, W, C) or a batch (B, H, W, C) is one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.accgrad_reduce.kernel import accgrad_reduce_cuda
from repro_torch.kernels.accgrad_reduce.ref import accgrad_reduce_ref


def accgrad_reduce(g: torch.Tensor, hq: torch.Tensor,
                   lq: torch.Tensor) -> torch.Tensor:
    """g, hq, lq (H, W, C) or (B, H, W, C) -> (H/16, W/16) or (B, H/16,
    W/16)."""
    if not on_cuda(g, "accgrad_reduce"):
        return accgrad_reduce_ref(g, hq, lq)
    if g.dim() == 3:
        return accgrad_reduce(g[None], hq[None], lq[None])[0]
    return accgrad_reduce_cuda(g.contiguous(), hq.contiguous(),
                               lq.contiguous())
