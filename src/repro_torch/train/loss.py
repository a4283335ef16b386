"""Chunked cross-entropy (port of ``repro.train.loss``).

The full (B, S, V) logits are never held at once: the sequence is cut
into chunks, and each chunk's logits, log-sum-exp and gold logit run
under ``torch.utils.checkpoint`` (the reference's checkpointed scan), so
that the backward recomputes one chunk's (B, c, V) fp32 logits at a time (nothing in it
draws random numbers, so no generator state is kept for the recompute).
The reference constrains the logits to its vocab-sharded layout; on one
card there is nothing to shard (ROADMAP module 8).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG = -1e30  # the padded vocabulary's logit


def _chunk_nll(hb, w, lb, mb, pad):
    """One chunk: (sum of the masked nll, sum of the mask), fp32."""
    logits = (hb @ w).to(torch.float32) + pad
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
    nll = (lse - gold) * mb
    return nll.sum(), mb.sum()


def chunked_softmax_xent(h, w_unembed, labels, *, real_vocab: int,
                         chunk: int = 256, mask=None):
    """h (B, S, d); w_unembed (d, V_padded); labels (B, S) int; mask (B,
    S) or None (every token) -> (mean nll over the masked tokens, their
    count), fp32 tensors.

    The chunk is the largest c <= ``chunk`` that divides S. Logits are
    ``h @ w`` in h's type, then fp32; columns from ``real_vocab`` on get
    -1e30, so they are never predicted."""
    B, S, _ = h.shape
    V = w_unembed.shape[1]
    c = min(chunk, S)
    while S % c:
        c -= 1
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    vocab_mask = (torch.arange(V, device=h.device) < real_vocab).to(
        torch.float32)
    pad = (1.0 - vocab_mask) * NEG
    w = w_unembed.to(h.dtype)  # cast once, not once a chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, c):
        t, n = checkpoint(_chunk_nll, h[:, i:i + c], w, labels[:, i:i + c],
                          mask[:, i:i + c].to(torch.float32), pad,
                          use_reentrant=False, preserve_rng_state=False)
        total, count = total + t, count + n
    return total / torch.clamp(count, min=1.0), count
