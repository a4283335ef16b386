"""Plain PyTorch version of single-token GQA attention against a KV cache
(port of ``repro/kernels/decode_attn/ref.py``). It serves CPU tensors and
the kernel checks; like the reference it works in fp32 whatever the
input type, and masks positions after ``pos`` with the sentinel -1e30.
An int8 cache is dequantized first, as the reference model's decode
reads it."""
from __future__ import annotations

import math

import torch


def decode_attn_ref(q: torch.Tensor, k, v, pos) -> torch.Tensor:
    """q: (B, KV, G, hd); k/v: (B, S, KV, hd), or the int8 cache form
    ``{"q", "s"}``, first read as ``cache_read(c, q.dtype)``; pos:
    inclusive last valid index, an int or a one-element integer tensor.
    Returns (B, KV, G, hd) in fp32."""
    if isinstance(k, dict) or isinstance(v, dict):
        # the model's layers import this package: import at call time
        from repro_torch.models.layers import cache_read

        k, v = cache_read(k, q.dtype), cache_read(v, q.dtype)
    S = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k.float()) * scale
    valid = torch.arange(S, device=k.device) <= pos
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v.float())
