"""RWKV6 ("Finch") time-mix with data-dependent decay, and channel-mix
(port of ``repro.models.rwkv6``).

As in the reference, the token-shift interpolation weights are static
and the decay keeps the data-dependent LoRA form. The WKV recurrence is
``kernels.wkv6``: the CUDA kernel on the card at prefill and at every
decode step, the reference model's chunked form on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.models.layers import _param, draw_normal


def token_shift(x, last=None):
    """x_{t-1} along the sequence; ``last`` (B, d) is the carry for decode
    and chunking."""
    pad = torch.zeros_like(x[:, :1]) if last is None \
        else last[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


class RWKV6TimeMix(nn.Module):
    def __init__(self, d_model, head_size, decay_lora, gate_lora,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.d_model, self.head_size = d_model, head_size
        d, f32 = d_model, torch.float32
        self.mu = _param((5, d), f32, device)  # r, k, v, g, w mix coefs
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _param((d, d), dtype, device))
        self.w0 = _param((d,), f32, device)
        self.w_lora_a = _param((d, decay_lora), f32, device)
        self.w_lora_b = _param((decay_lora, d), f32, device)
        self.u = _param((self.n_heads, head_size), f32, device)
        self.ln_scale = _param((d,), f32, device)
        self.ln_bias = _param((d,), f32, device)

    @property
    def n_heads(self):
        return self.d_model // self.head_size

    def reset(self, generator):
        d, dev = self.d_model, self.mu.device
        s = 1.0 / math.sqrt(d)
        self.mu.fill_(0.5)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            w = getattr(self, name)
            w.copy_(draw_normal(w.shape, s, w.dtype, generator, dev))
        # decay base: spread over the channels as the reference's
        base = torch.exp(-(5.0 + torch.linspace(0.0, 4.0, d,
                                                dtype=torch.float32,
                                                device=dev)))
        self.w0.copy_(torch.log(base + 1e-9))
        self.w_lora_a.copy_(draw_normal(self.w_lora_a.shape, s, torch.float32,
                                        generator, dev))
        self.w_lora_b.zero_()
        self.u.copy_(draw_normal(self.u.shape, 0.1, torch.float32, generator,
                                 dev))
        self.ln_scale.fill_(1.0)
        self.ln_bias.zero_()

    def forward(self, x, state=None):
        """x (B, S, d); state None or {"shift" (B, d), "wkv" (B, H, hd,
        hd)}. Returns (out, new_state)."""
        B, S, d = x.shape
        H, hd = self.n_heads, self.head_size
        xx = token_shift(x, None if state is None else state["shift"])
        mu = self.mu.to(x.dtype)
        mr, mk, mv, mg, mw = x[None] + (xx - x)[None] * mu[:, None, None, :]

        r = (mr @ self.w_r.to(x.dtype)).reshape(B, S, H, hd)
        k = (mk @ self.w_k.to(x.dtype)).reshape(B, S, H, hd)
        v = (mv @ self.w_v.to(x.dtype)).reshape(B, S, H, hd)
        g = F.silu(mg @ self.w_g.to(x.dtype))

        # data-dependent decay (the Finch contribution)
        w = self.w0 + torch.tanh(mw.float() @ self.w_lora_a) @ self.w_lora_b
        log_decay = (-torch.exp(w.float())).reshape(B, S, H, hd)

        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device) if state is None else state["wkv"]
        o, s_new = wkv6(r, k, v, log_decay, self.u.float(), s0)

        # per-head group norm (population variance, as jnp's var)
        o = o.reshape(B, S, H, hd).float()
        mean = o.mean(-1, keepdim=True)
        var = o.var(-1, keepdim=True, unbiased=False)
        o = (o - mean) * torch.rsqrt(var + 64e-5)
        o = o.reshape(B, S, d) * self.ln_scale + self.ln_bias
        o = o.to(x.dtype) * g
        out = o @ self.w_o.to(x.dtype)
        return out, {"shift": x[:, -1], "wkv": s_new}


class RWKV6ChannelMix(nn.Module):
    def __init__(self, d_model, d_ff, dtype=torch.float32, device="cuda"):
        super().__init__()
        d, f = d_model, d_ff
        self.mu = _param((2, d), torch.float32, device)  # k, r
        self.w_k = _param((d, f), dtype, device)
        self.w_v = _param((f, d), dtype, device)
        self.w_r = _param((d, d), dtype, device)

    def reset(self, generator):
        d, f = self.w_k.shape
        dev = self.mu.device
        self.mu.fill_(0.5)
        for w, d_in in ((self.w_k, d), (self.w_v, f), (self.w_r, d)):
            w.copy_(draw_normal(w.shape, 1.0 / math.sqrt(d_in), w.dtype,
                                generator, dev))

    def forward(self, x, state=None):
        xx = token_shift(x, None if state is None else state["shift"])
        mu = self.mu.to(x.dtype)
        mk = x + (xx - x) * mu[0]
        mr = x + (xx - x) * mu[1]
        k = torch.square(F.relu(mk @ self.w_k.to(x.dtype)))
        kv = k @ self.w_v.to(x.dtype)
        out = torch.sigmoid(mr @ self.w_r.to(x.dtype)) * kv
        return out, {"shift": x[:, -1]}
