"""AccGrad, the paper's core quantity (Eq. 1), port of
``repro.core.accgrad``.

AccGrad_B = sum_{i in B} || d Acc(D(X); D(H)) / dX_i |_{X=L} ||_1
            * || H_i - L_i ||_1

computed with two forward passes (D(H) for the reference outputs, D(L)
inside the gradient) and one backward pass through the final DNN. The
per-pixel |g| * |H - L| -> 16x16 block-sum reduction goes through
:mod:`repro_torch.kernels.accgrad_reduce`: one kernel launch per batch on
the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.codec.dct import MB
from repro_torch.kernels.accgrad_reduce.ops import accgrad_reduce


def block_reduce(x: torch.Tensor, block: int = MB) -> torch.Tensor:
    """(..., H, W) -> (..., H/block, W/block) sum."""
    *lead, H, W = x.shape
    x = x.reshape(*lead, H // block, block, W // block, block)
    return x.sum(dim=(-3, -1))


def _grad_at(loss_fn, x: torch.Tensor) -> torch.Tensor:
    """d loss_fn / dx at ``x``, through ``torch.autograd.grad`` so that no
    parameter of the model gathers a ``.grad``."""
    leaf = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_fn(leaf), leaf)
    return g


def accgrad_frames(final_dnn, hq: torch.Tensor,
                   lq: torch.Tensor) -> torch.Tensor:
    """hq/lq: (B, H, W, 3) high/low-quality frames.

    Returns AccGrad grids (B, H/16, W/16), normalised per frame to [0, 1]
    (the paper's alpha threshold is relative).
    """
    ref_out = final_dnn.predict(hq)
    g = _grad_at(lambda x: final_dnn.proxy_loss(x, ref_out), lq)
    grid = accgrad_reduce(g, hq, lq)  # one launch for the batch
    mx = grid.amax(dim=(-2, -1), keepdim=True)
    return grid / mx.clamp_min(1e-12)


def accgrad_embeddings(loss_fn, hq_embeds: torch.Tensor,
                       lq_embeds: torch.Tensor,
                       group: int = 1) -> torch.Tensor:
    """AccGrad over frontend token embeddings (B, T, D): how much each
    token's (or each ``group`` of tokens') encoding quality moves the
    model output. ``loss_fn(embeds)`` must be differentiable. Returns
    scores normalised per row."""
    g = _grad_at(loss_fn, lq_embeds)
    per_tok = g.abs().sum(-1) * (hq_embeds - lq_embeds).abs().sum(-1)
    if group > 1:
        B, T = per_tok.shape
        per_tok = per_tok[:, : T - T % group].reshape(B, -1, group).sum(-1)
    mx = per_tok.amax(dim=-1, keepdim=True)
    return per_tok / mx.clamp_min(1e-12)
