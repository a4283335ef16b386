"""Mamba-1 selective SSM, jamba's sequence mixer (port of
``repro.models.mamba``).

The reference has no Pallas kernel here: it computes the selective scan
in jnp, an outer ``lax.scan`` over chunks of the sequence carrying the
(B, d_inner, N) state and an ``associative_scan`` inside each chunk. The
port keeps the outer chunking, so that the (chunk, B, d_inner, N)
decays and inputs are the largest transients (the full (B, S, d_inner,
N) tensors would take 17.2 GB each at jamba's width, batch 16 and 1024
tokens; a chunk of 32 takes 537 MB), and steps through each chunk in
order, one multiply-add on a (B, d_inner, N) slice a position. The scan
runs in fp32 whatever the compute type, as the reference's.

A decode step is the same call at S = 1 with the state of the prefill:
its shapes follow from the call alone, so a CUDA graph captures it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import loop
from repro_torch.models.layers import _param, draw_normal

SSM_CHUNK = 32


def _scan_chunk(x_b, d_b, b_b, c_b, A, h, in_place: bool):
    """One chunk, (cs, B, ...) slices, from the state ``h`` -> (y (B, cs,
    d_inner), the state after it). ``in_place`` steps the states inside
    one buffer (serving); otherwise each is a tensor of its own, as
    autograd needs, and the same bits: one ``addcmul`` a position
    either way."""
    cs = x_b.shape[0]
    a = torch.exp(d_b[..., None] * A)                    # (cs, B, din, N)
    hs = (d_b * x_b)[..., None] * b_b[:, :, None, :]     # then the states
    if in_place:
        loop(lambda t, prev: (None, hs[t].addcmul_(a[t], prev)), range(cs),
             h)
        h = hs[-1].clone()
    else:
        def step(t, prev):
            state = torch.addcmul(hs[t], a[t], prev)
            return state, state

        states, h = loop(step, range(cs), h)
        hs = torch.stack(states)
    return torch.einsum("tbdn,tbn->btd", hs, c_b), h


def selective_scan_chunked(x, delta, A, b, c, h0, chunk: int = SSM_CHUNK):
    """Diagonal selective scan, h_t = exp(delta_t A) h_{t-1} + delta_t x_t
    b_t, y_t = h_t c_t, in fp32.

    x, delta (B, S, d_inner); A (d_inner, N); b, c (B, S, N); h0 (B,
    d_inner, N) -> (y (B, S, d_inner), the last state (B, d_inner, N)).
    A chunk that does not divide S shrinks until it does, as the
    reference's. Inside a chunk each position's state is one ``addcmul``
    of the one before: no cumulative product is divided out (exp(delta A)
    underflows over a chunk). Where autograd records the call, each chunk
    runs under ``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` of its chunk body: the backward recomputes one
    chunk's (cs, B, d_inner, N) states at a time."""
    B, S, din = x.shape
    cs = min(chunk, S)
    while S % cs:
        cs -= 1
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, delta, A, b, c, h0))

    def one(s0, h):
        # (cs, B, ...) so that one position's slice is contiguous
        x_b, d_b, b_b, c_b = (t[:, s0:s0 + cs].transpose(0, 1)
                              for t in (x, delta, b, c))
        if grad:
            return checkpoint(_scan_chunk, x_b, d_b, b_b, c_b, A, h, False,
                              use_reentrant=False, preserve_rng_state=False)
        return _scan_chunk(x_b, d_b, b_b, c_b, A, h, True)

    ys, h = loop(one, range(0, S, cs), h0)
    return torch.cat(ys, dim=1), h


class Mamba(nn.Module):
    """The Mamba-1 mixer. Parameters carry the reference's names and
    layouts (Linear weights (d_in, d_out)); ``in_proj``, ``x_proj`` and
    ``out_proj`` are held in ``dtype``, the convolution, ``dt_*``,
    ``A_log`` and ``D`` in fp32 whatever ``dtype`` is."""

    def __init__(self, d_model, d_state=16, d_conv=4, expand=2, dt_rank=0,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.d_inner = expand * d_model
        self.dtr = dt_rank or -(-d_model // 16)
        d, din, n, f32 = d_model, self.d_inner, d_state, torch.float32
        self.in_proj = _param((d, 2 * din), dtype, device)
        self.conv_w = _param((d_conv, din), f32, device)
        self.conv_b = _param((din,), f32, device)
        self.x_proj = _param((din, self.dtr + 2 * n), dtype, device)
        self.dt_proj = _param((self.dtr, din), f32, device)
        self.dt_bias = _param((din,), f32, device)
        self.A_log = _param((din, n), f32, device)
        self.D = _param((din,), f32, device)
        self.out_proj = _param((din, d), dtype, device)

    def reset(self, generator):
        """The reference's distributions: the projections N(0, 1/d_in),
        the convolution's taps N(0, 1/d_conv) and zero bias, dt's bias the
        inverse softplus of a log-uniform draw over [1e-3, 0.1], A_log
        log(1..N) in every channel, D 1."""
        dev = self.A_log.device
        for w, fan_in in ((self.in_proj, self.d_model),
                          (self.conv_w, self.d_conv),
                          (self.x_proj, self.d_inner),
                          (self.dt_proj, self.dtr),
                          (self.out_proj, self.d_inner)):
            w.copy_(draw_normal(w.shape, 1.0 / math.sqrt(fan_in), w.dtype,
                                generator, dev))
        self.conv_b.zero_()
        gdev = generator.device if generator is not None else dev
        u = torch.rand((self.d_inner,), generator=generator,
                       dtype=torch.float32, device=gdev).to(dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_log.copy_(torch.log(torch.arange(
            1, self.d_state + 1, dtype=torch.float32,
            device=dev)).expand(self.d_inner, -1))
        self.D.fill_(1.0)

    def _conv(self, xin, state):
        """The causal depthwise conv as d_conv shifted products in xin's
        type, summed in the reference's order, then SiLU -> (xc, the new
        conv state: the last d_conv - 1 inputs, zero-padded after a
        prefill, as a tensor of its own)."""
        S, k = xin.shape[1], self.d_conv
        if state is None:
            padded = F.pad(xin, (0, 0, k - 1, 0))
        else:
            padded = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)
        conv = padded[:, 0:S] * self.conv_w[0].to(xin.dtype)
        for i in range(1, k):
            conv = conv + padded[:, i:i + S] * self.conv_w[i].to(xin.dtype)
        xc = F.silu(conv + self.conv_b.to(xin.dtype))
        return xc, padded[:, -(k - 1):].to(torch.float32, copy=True)

    def _ssm(self, xc, h0):
        """The selective SSM over xc (B, S, d_inner) from ``h0`` (zeros
        when None) -> (y + xc D in fp32, the last state)."""
        n = self.d_state
        proj = xc @ self.x_proj.to(xc.dtype)
        dt, b_ssm, c_ssm = proj.split([self.dtr, n, n], dim=-1)
        delta = F.softplus(dt.float() @ self.dt_proj + self.dt_bias)
        if h0 is None:
            h0 = torch.zeros((xc.shape[0], self.d_inner, n),
                             dtype=torch.float32, device=xc.device)
        xcf = xc.float()
        y, h = selective_scan_chunked(xcf, delta, -torch.exp(self.A_log),
                                      b_ssm.float(), c_ssm.float(), h0)
        return y + xcf * self.D, h

    def forward(self, x, state=None):
        """x (B, S, d); state None (a prefill from zeros) or {"conv" (B,
        d_conv - 1, d_inner), "ssm" (B, d_inner, N)}, both fp32. Returns
        (out (B, S, d) in x's type, the new state): after a prefill the
        conv state is the tail of the zero-padded input."""
        xin, z = (x @ self.in_proj.to(x.dtype)).chunk(2, dim=-1)
        xc, conv_state = self._conv(xin, state)
        y, h = self._ssm(xc, None if state is None else state["ssm"])
        y = (y * F.silu(z.float())).to(x.dtype)
        return y @ self.out_proj.to(x.dtype), {"conv": conv_state, "ssm": h}
