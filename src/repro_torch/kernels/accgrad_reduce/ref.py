"""Plain PyTorch version of the AccGrad reduction kernel: per pixel
(sum_c |g|) * (sum_c |H - L|), summed over each 16x16 macroblock. It
serves CPU tensors and the kernel checks."""
from __future__ import annotations

import torch

from repro_torch.codec.dct import MB


def accgrad_reduce_ref(g: torch.Tensor, hq: torch.Tensor,
                       lq: torch.Tensor) -> torch.Tensor:
    """g, hq, lq: one frame (H, W, C) or a batch (B, H, W, C) -> (H/16,
    W/16) or (B, H/16, W/16)."""
    per_pixel = g.abs().sum(-1) * (hq - lq).abs().sum(-1)
    *lead, H, W = per_pixel.shape
    x = per_pixel.reshape(*lead, H // MB, MB, W // MB, MB)
    return x.sum(dim=(-3, -1))
