"""Plain PyTorch version of single-token GQA attention against a KV cache
(port of ``repro/kernels/decode_attn/ref.py``). It serves CPU tensors and
the kernel checks; like the reference it works in fp32 whatever the
input type, and masks positions after ``pos`` with the sentinel -1e30."""
from __future__ import annotations

import math

import torch


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos) -> torch.Tensor:
    """q: (B, KV, G, hd); k/v: (B, S, KV, hd); pos: inclusive last valid
    index, an int or a one-element integer tensor. Returns (B, KV, G, hd)
    in fp32."""
    S = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k.float()) * scale
    valid = torch.arange(S, device=k.device) <= pos
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v.float())
