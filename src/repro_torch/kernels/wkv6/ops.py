"""Public entry point of the RWKV6 WKV recurrence (the time-mix hot loop).

A CUDA tensor launches the hand-written kernel (``kernel.py``), which
either runs or raises; a CPU tensor takes the reference model's chunked
form (``ref.wkv_chunked``). Any length runs as it is, one token included:
nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv_chunked


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_decay: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, v (B, S, H, hd) (bf16 or fp32), log_decay (B, S, H, hd) fp32,
    u (H, hd), s0 (B, H, hd, hd) -> (o (B, S, H, hd), state (B, H, hd,
    hd)), both fp32."""
    if not on_cuda(r, "wkv6"):
        return wkv_chunked(r, k, v, log_decay, u, s0)
    return wkv6_cuda(*(t.contiguous() for t in (r, k, v, log_decay,
                                                u.float(), s0.float())))
