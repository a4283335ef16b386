"""Plain PyTorch version of single-token GQA attention against a KV cache
(port of ``repro/kernels/decode_attn/ref.py``). It serves CPU tensors and
the kernel checks; like the reference it works in fp32 whatever the
input type, and masks positions after ``pos`` with the sentinel -1e30.
An int8 cache is dequantized first, as the reference model's decode
reads it. :func:`dequantize_bits` is the plain twin of the kernel's own
dequantize arithmetic, which must give those values bit for bit."""
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


def dequantize_bits(c, dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 form ``{"q", "s"}`` read as ``cache_read(c, dtype)`` (bf16
    or fp32) by the CUDA kernel's arithmetic, in int32 bits: each int8
    value, biased to 0..255, becomes the low mantissa byte of 2^23 and
    2^23 + 128 is subtracted (exact); the fp32 product with its scale is
    rounded to bf16 to nearest even on its bits, the rule of the kernel's
    ``cvt.rn.bf16x2.f32``. Finite scales only, as the cache holds."""
    biased = (c["q"].to(torch.int32) & 0xFF) ^ 0x80
    x = (biased | 0x4B000000).view(torch.float32) - 8388736.0
    y = x * c["s"]
    if dtype == torch.float32:
        return y
    if dtype != torch.bfloat16:
        raise ValueError(f"the kernel reads the int8 form as bf16 or fp32, "
                         f"got {dtype}")
    bits = y.view(torch.int32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & -65536
    return bits.view(torch.float32).to(torch.bfloat16)
