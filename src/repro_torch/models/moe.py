"""Mixture-of-Experts, the dense path (port of ``repro.models.moe``).

Top-k routing with per-expert capacity C = ceil(ceil(k T / E) cf) over
the T tokens of one call (at most T): each expert keeps its C tokens of
highest gate, the rest of its tokens are dropped (the residual carries
them) and the drop fraction is reported beside the switch-transformer
load-balancing loss. This is the reference's ``dense`` implementation
(``MoE._apply_dense``), its single-device path; the expert-parallel
``ep`` path (``shard_map`` and ``all_to_all``) comes with the multi-GPU
slice (ROADMAP, module 8).

Everything runs on the activations' device with shapes fixed by the
call's shape alone (C is computed on the host from T), so a decode step
holding a MoE layer is captured as one CUDA graph:
- both top-k's (a token's k experts, an expert's C tokens) break ties
  toward the lower index, as ``jax.lax.top_k`` does: a stable descending
  sort and a slice, where ``torch.topk`` promises no order among ties;
- the expert products are three batched matrix products (the reference
  computes them outside any Pallas kernel too);
- the combine is a gather, not a scatter-add: each token sums its kept
  (expert, slot) outputs in ascending expert order, from zero in the
  outputs' type, the order of the reference's expert-major scatter-add.
  No atomics, so the same bits on every call, eager or replayed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _param, draw_normal


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    largest first, equal values in ascending index order (as
    ``jax.lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class Router(nn.Module):
    """The router's (d, E) weight ``w``, fp32 whatever the experts' type."""

    def __init__(self, d_model, n_experts, device="cuda"):
        super().__init__()
        self.w = _param((d_model, n_experts), torch.float32, device)


class MoE(nn.Module):
    """Top-k routed SwiGLU experts: ``router.w`` (d, E) fp32, ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d) in ``dtype``, the reference
    tree's names. ``forward(x)`` takes x (B, S, d) and returns (out (B, S,
    d) of x's type, (aux, drop_frac) fp32 scalars)."""

    def __init__(self, d_model, d_ff, n_experts, top_k, capacity_factor=1.25,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.d_model, self.d_ff = d_model, d_ff
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        E, d, f = n_experts, d_model, d_ff
        self.router = Router(d, E, device=device)
        self.w_gate = _param((E, d, f), dtype, device)
        self.w_up = _param((E, d, f), dtype, device)
        self.w_down = _param((E, f, d), dtype, device)

    def reset(self, generator):
        """Router and w_gate, w_up N(0, 1/d); w_down N(0, 1/f)."""
        s_in, s_out = 1.0 / math.sqrt(self.d_model), 1.0 / math.sqrt(
            self.d_ff)
        for w, s in ((self.router.w, s_in), (self.w_gate, s_in),
                     (self.w_up, s_in), (self.w_down, s_out)):
            w.copy_(draw_normal(w.shape, s, w.dtype, generator, w.device))

    def capacity(self, T: int) -> int:
        """Tokens an expert keeps out of a call's ``T``."""
        c = ceil_div(self.top_k * T, self.n_experts)
        return min(T, max(1, int(math.ceil(c * self.capacity_factor))))

    def route(self, xf):
        """xf (T, d) -> (gates (T, E) fp32, zero but at each token's k
        experts, where they hold its normalised top-k probabilities; the
        k experts (T, k), largest first; the load-balancing loss)."""
        logits = xf.float() @ self.router.w
        probs = torch.softmax(logits, dim=-1)
        topw, topi = top_k(probs, self.top_k)
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
        gates = torch.zeros_like(probs).scatter_(1, topi, topw)
        frac_tokens = (gates > 0).float().mean(0)  # (E,)
        frac_probs = probs.mean(0)
        aux = self.n_experts * torch.sum(frac_tokens * frac_probs)
        return gates, topi, aux

    def expert_ffn(self, xin):
        """xin (E, C, d) -> (E, C, d): each expert's SwiGLU in xin's type."""
        dt = xin.dtype
        gate = torch.bmm(xin, self.w_gate.to(dt))
        up = torch.bmm(xin, self.w_up.to(dt))
        return torch.bmm(F.silu(gate) * up, self.w_down.to(dt))

    def forward(self, x):
        B, S, d = x.shape
        T, E = B * S, self.n_experts
        xf = x.reshape(T, d)
        gates, topi, aux = self.route(xf)
        C = self.capacity(T)
        gate, idx = top_k(gates.T, C)  # (E, C): each expert's tokens
        valid = gate > 0
        xin = xf.index_select(0, idx.reshape(-1)).reshape(E, C, d)
        xin = xin * valid[..., None].to(x.dtype)
        y = self.expert_ffn(xin)
        y = y * (gate * valid)[..., None].to(y.dtype)
        # the combine: slot[e, t], token t's slot in expert e's outputs,
        # or C (a zero row) where e did not keep it; an expert's C tokens
        # are distinct, so the scatter writes each entry once
        slots = torch.arange(C, device=x.device).expand(E, C)
        slot = torch.full((E, T), C, dtype=torch.long, device=x.device)
        slot.scatter_(1, idx, torch.where(valid, slots, C))
        ypad = torch.cat([y, y.new_zeros(E, 1, d)], dim=1).reshape(-1, d)
        experts = torch.sort(topi, dim=-1).values  # ascending: the order
        rows = experts * (C + 1) + slot.gather(0, experts.T.contiguous()).T
        picked = ypad[rows]  # (T, k, d): one gather for every slot
        out = torch.zeros((T, d), dtype=y.dtype, device=x.device)
        for j in range(self.top_k):
            out = out + picked[:, j]
        kept = valid.sum().float()
        drop = 1.0 - kept / torch.clamp((gates > 0).sum(), min=1).float()
        return out.reshape(B, S, d), (aux, drop)


@torch.no_grad()
def moe_exact_reference(moe: MoE, x):
    """Dropless per-token mixture (tiny inputs only): each token through its
    own top-k experts' weights, the test oracle (port of the reference's
    ``moe_exact_reference``)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.float() @ moe.router.w, dim=-1)
    topw, topi = top_k(probs, moe.top_k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    out = torch.zeros_like(xf)
    dt = xf.dtype
    for j in range(moe.top_k):
        wg = moe.w_gate[topi[:, j]].to(dt)  # (T, d, f)
        wu = moe.w_up[topi[:, j]].to(dt)
        wd = moe.w_down[topi[:, j]].to(dt)
        gate = torch.einsum("td,tdf->tf", xf, wg)
        up = torch.einsum("td,tdf->tf", xf, wu)
        y = torch.einsum("tf,tfd->td", F.silu(gate) * up, wd)
        out = out + y * topw[:, j][:, None].to(y.dtype)
    return out.reshape(B, S, d)
