"""Public entry point of flash-decoding attention.

A CUDA tensor launches the hand-written kernel (``kernel.py``), which
either runs or raises; a CPU tensor takes the plain PyTorch version
(``ref.py``). Either way the result is fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.kernels.decode_attn.ref import decode_attn_ref


def decode_attn(q: torch.Tensor, k, v, pos) -> torch.Tensor:
    """q (B, KV, G, hd); k/v (B, S, KV, hd) of q's type (bf16 or fp32), or
    both the int8 cache form ``{"q", "s"}``, attended as ``cache_read(c,
    q.dtype)``; positions after ``pos`` are masked -> (B, KV, G, hd) fp32.
    ``pos`` is an int or a one-element int32 tensor on q's device (the
    reference's (1,) array); on the card the kernel reads the tensor
    there."""
    if not on_cuda(q, "decode_attn"):
        return decode_attn_ref(q, k, v, pos)
    return decode_attn_cuda(q.contiguous(), k, v, pos)
