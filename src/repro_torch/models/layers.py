"""Core layers of the LM scaffold (port of ``repro.models.layers``).

Modules hold their parameters under the reference tree's names (``w``,
``b``, ``emb``, ``scale``, ``bias``), with Linear weights in the
reference's (d_in, d_out) layout, so that ``repro_torch.weights`` carries a
parameter tree across key for key. Each module's ``reset(generator)``
draws its parameters from the reference's distributions. Every module
takes a ``device`` (default ``"cuda"``, which raises where there is
none). Compute follows the reference: weights are cast to the
activations' type at use, norms and softmaxes work in fp32.

One card, so the reference's sharding rules, head / qhead / seq policies
and context-parallel attention are not ported.

Decode takes ``pos`` as a Python int or as a one-element integer tensor on
the activations' device (the reference's traced position): with a tensor,
the rotary angle, the cache write and the attention mask read it on the
card, so one captured CUDA graph of a decode step serves every position.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import loop, resolve_device
from repro_torch.kernels.decode_attn.ops import decode_attn


def draw_normal(shape, scale, dtype, generator, device):
    """``scale * N(0, 1)`` drawn in fp32 from ``generator`` (on its own
    device; the default generator of ``device`` when None), then cast to
    ``dtype`` on ``device``, as the reference's ``normal_init``."""
    gdev = generator.device if generator is not None else device
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=gdev)
    # scaled in place: one fp32 copy of the draw at a time (jamba's MoE
    # weights are 12.9 GB each in fp32)
    return x.mul_(scale).to(device=device, dtype=dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype,
                                    device=resolve_device(device)),
                        requires_grad=False)


class Linear(nn.Module):
    """y = x @ w (+ b); ``w`` is (d_in, d_out), drawn with std
    1/sqrt(d_in)."""

    def __init__(self, d_in, d_out, bias=False, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None

    def reset(self, generator):
        self.w.copy_(draw_normal(self.w.shape, 1.0 / math.sqrt(
            self.w.shape[0]), self.w.dtype, generator, self.w.device))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x):
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class Embedding(nn.Module):
    def __init__(self, vocab, d_model, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.emb = _param((vocab, d_model), dtype, device)

    def reset(self, generator):
        # GPT-2-style scale: keeps tied-unembedding logits O(1) at init
        self.emb.copy_(draw_normal(self.emb.shape, 0.02, self.emb.dtype,
                                   generator, self.emb.device))

    def forward(self, tokens, compute_dtype):
        return F.embedding(tokens, self.emb).to(compute_dtype)

    def attend(self, x):
        """Tied unembedding: (B, S, d) @ (d, V) -> logits."""
        return x @ self.emb.to(x.dtype).T


class Norm(nn.Module):
    """RMSNorm or LayerNorm (eps 1e-5), computed in fp32 and cast back."""

    def __init__(self, d, kind="rmsnorm", device="cuda"):
        super().__init__()
        self.kind = kind
        self.scale = _param((d,), torch.float32, device)
        self.bias = (_param((d,), torch.float32, device)
                     if kind == "layernorm" else None)

    def reset(self, generator):
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dt = x.dtype
        x = x.float()
        if self.kind == "layernorm":
            x = x - x.mean(-1, keepdim=True)
        var = (x * x).mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + 1e-5) * self.scale
        if self.bias is not None:
            x = x + self.bias
        return x.to(dt)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def rotary_embedding(positions, head_dim: int, theta: float, dtype):
    """positions (...,) int -> cos, sin of shape (..., head_dim // 2),
    computed in fp32 and cast to ``dtype``."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x, cos, sin):
    """Half-split rotary. x (B, S, H, hd); cos/sin (B, S, hd//2) or
    (S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(positions, d_model: int, dtype):
    """positions (...,) int, on the device the result goes to -> (...,
    d_model): sin of each angle in the first half, cos in the second,
    computed in fp32 and cast to ``dtype``. A decode step passes its
    ``pos`` as a one-element tensor, read on the card."""
    half = d_model // 2
    freqs = 1.0 / (10_000.0 ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device)
                                / half))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def quantize_kv(x):
    """(..., hd) bf16/fp32 -> {"q": int8, "s": fp32 (..., 1)}: per-vector
    absmax in fp32, ``max(scale, 1e-8) / 127``, round half to even, clip to
    +-127 (the reference's int8 cache)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return {"q": q.to(torch.int8), "s": scale}


def cache_read(c, dtype=torch.bfloat16):
    """A cache buffer as a tensor of ``dtype``: the int8 form dequantized as
    ``(q.float() * s).to(dtype)``; a plain buffer as it is."""
    if isinstance(c, dict):
        return (c["q"].float() * c["s"]).to(dtype)
    return c


def cache_write(c, new, pos):
    """Write one token's (B, 1, ...) ``new`` at ``pos`` along axis 1 of the
    cache (quantized first for the int8 form), in place, and return the
    cache. The reference's ``dynamic_update_slice`` clamps the start, so an
    int ``pos`` past the end would overwrite the last token; here it raises.
    A tensor ``pos`` is read on the card without a check: its caller knows
    the position on the host and checks it there."""
    if isinstance(c, dict):
        qn = quantize_kv(new)
        cache_write(c["q"], qn["q"], pos)
        cache_write(c["s"], qn["s"], pos)
        return c
    if isinstance(pos, torch.Tensor):
        c.index_copy_(1, pos.reshape(1).long(), new.to(c.dtype))
        return c
    if not 0 <= pos < c.shape[1]:
        raise IndexError(f"cache_write at pos {pos} outside a cache of "
                         f"{c.shape[1]} tokens; prefill with max_seq to "
                         f"leave room for decoding")
    c[:, pos:pos + 1] = new.to(c.dtype)
    return c


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


Q_CHUNK = 512  # the reference's query chunk
SCORE_BYTES = 1 << 30  # one query chunk's fp32 scores, at most


def query_chunk(B: int, H: int, S: int, Sk: int) -> int:
    """The query chunk of :func:`chunked_attention` for ``S`` queries of
    ``H`` heads over ``Sk`` keys at batch ``B``: the largest divisor of S
    that is at most :data:`Q_CHUNK` and keeps one chunk's fp32 scores (B,
    H, chunk, Sk) within :data:`SCORE_BYTES`, or 1. llama-3.2-vision-90b's
    cross layers at batch 16 over 6,404 image tokens take 32 of a
    1024-token prompt (0.84 GB of scores, where 512 would take 13.4 GB)."""
    most = max(1, min(Q_CHUNK, S, SCORE_BYTES // (4 * B * H * Sk)))
    return next(c for c in range(most, 0, -1) if S % c == 0)


def chunked_attention(q, k, v, causal: bool = True,
                      q_chunk: int = Q_CHUNK):
    """Exact attention over query chunks (memory O(chunk x Sk)): scores
    in fp32, probabilities cast to v's type for the value product; with
    ``causal`` query i attends keys 0..i, else every key (no mask).

    q (B, S, H, hd); k, v (B, Sk, KV, hd), KV dividing H: query head h
    attends KV head h // (H // KV), as the reference's head-expanded K/V
    (KV = H, which it passes, is the same call). A chunk that does not
    divide S falls back to one block of all S rows. Each query row's
    scores, mask, softmax and weighted sum involve that row and the keys
    only, so the result does not depend on the chunk: only the blocking
    of the products over hd and Sk may change the order of their sums."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    c = min(q_chunk, S)
    if S % c != 0:  # a single exact block
        c = S
    # (B, KV, Sk, hd) once, not per chunk: the products' batch is (B, KV),
    # each KV head's G query heads stacked as rows
    kf = k.float().transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    cols = torch.arange(Sk, device=q.device)

    def one(idx, _):
        qb = q[:, idx * c:(idx + 1) * c].float().transpose(1, 2)
        s = (qb.reshape(B, KV, G * c, hd) @ kf.transpose(-1, -2)) * scale
        if causal:
            qpos = idx * c + torch.arange(c, device=q.device)
            mask = qpos[:, None] >= cols[None, :]
            s.view(B, KV, G, c, Sk).masked_fill_(~mask, -1e30)
        p = torch.softmax(s, dim=-1)
        o = (p.to(v.dtype) @ vh).reshape(B, H, c, hd)
        return o.transpose(1, 2), None

    return torch.cat(loop(one, range(S // c))[0], dim=1)


class Attention(nn.Module):
    """GQA attention: causal self-attention with rotary embeddings (none
    at ``rope_theta`` 0; with ``causal=False`` every position attends
    every other, as in an encoder), or with ``cross`` cross-attention (the
    reference's XATTN), whose K and V come from a context stream (B, Sk,
    d) with no rotary and no mask."""

    def __init__(self, d_model, n_heads, n_kv_heads, head_dim,
                 qkv_bias=False, rope_theta=10_000.0, causal: bool = True,
                 cross: bool = False, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.head_dim, self.rope_theta = head_dim, rope_theta
        self.causal, self.cross = causal, cross
        h, kvh, hd = n_heads, n_kv_heads, head_dim
        self.wq = Linear(d_model, h * hd, qkv_bias, dtype, device=device)
        self.wk = Linear(d_model, kvh * hd, qkv_bias, dtype, device=device)
        self.wv = Linear(d_model, kvh * hd, qkv_bias, dtype, device=device)
        self.wo = Linear(h * hd, d_model, False, dtype, device=device)

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def reset(self, generator):
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset(generator)

    def forward(self, x, positions=None, context=None,
                return_kv: bool = False):
        """x (B, S, d); ``context`` (B, Sk, d), the K/V source of a cross
        layer -> (out, (k, v) in the unexpanded (B, Sk, n_kv, hd) cache
        layout when ``return_kv``, else None)."""
        B, S, _ = x.shape
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        if self.cross and context is None:
            raise ValueError("a cross-attention layer needs its context")
        src = context if self.cross else x
        Sk = src.shape[1]
        q = self.wq(x).reshape(B, S, h, hd)
        k = self.wk(src).reshape(B, Sk, kvh, hd)
        v = self.wv(src).reshape(B, Sk, kvh, hd)
        if self.rope_theta > 0 and not self.cross:
            if positions is None:
                positions = torch.arange(S, device=x.device)
            cos, sin = rotary_embedding(positions, hd, self.rope_theta,
                                        x.dtype)
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        out = chunked_attention(q, k, v,
                                causal=self.causal and not self.cross,
                                q_chunk=query_chunk(B, h, S, Sk))
        return (self.wo(out.reshape(B, S, h * hd)),
                (k, v) if return_kv else None)

    def decode(self, x, cache_k, cache_v, pos):
        """x (B, 1, d); cache_k/v (B, S_max, n_kv, hd) of x's type, or the
        int8 form ``{"q", "s"}``. Self-attention writes the token's K/V
        into them in place at ``pos`` (an int, or a one-element int32
        tensor on x's device) and attends positions 0..pos; cross-attention
        writes nothing and attends the whole cache (``pos`` unused: the
        kernel's pos is the cache's last, which masks nothing), and returns
        the very tensors it was given. Grouped decode attention is
        ``kernels.decode_attn``: the CUDA kernel on the card, which reads
        an int8 cache as it is stored, its plain version on the CPU; both
        attend over ``cache_read(c, x.dtype)``, and the fp32 output is cast
        to x's type before ``wo``. Returns (out, cache_k, cache_v)."""
        B = x.shape[0]
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q = self.wq(x).reshape(B, 1, kvh, self.group, hd)
        if self.cross:
            S = (cache_k["q"] if isinstance(cache_k, dict)
                 else cache_k).shape[1]
            pos = S - 1
        else:
            kn = self.wk(x).reshape(B, 1, kvh, hd)
            vn = self.wv(x).reshape(B, 1, kvh, hd)
            if self.rope_theta > 0:
                if isinstance(pos, torch.Tensor):
                    posv = pos.reshape(1, 1).expand(B, 1)
                else:
                    posv = torch.full((B, 1), pos, dtype=torch.int32,
                                      device=x.device)
                cos, sin = rotary_embedding(posv, hd, self.rope_theta,
                                            x.dtype)
                q = apply_rotary(q.reshape(B, 1, h, hd), cos, sin).reshape(
                    B, 1, kvh, self.group, hd)
                kn = apply_rotary(kn, cos, sin)
            cache_k = cache_write(cache_k, kn, pos)
            cache_v = cache_write(cache_v, vn, pos)
        out = decode_attn(q.reshape(B, kvh, self.group, hd), cache_k,
                          cache_v, pos)
        out = out.to(x.dtype).reshape(B, 1, h * hd)
        return self.wo(out), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU or GELU (jax.nn.gelu's default tanh form) feed-forward."""

    def __init__(self, d_model, d_ff, act="swiglu", dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.act = act
        if act == "swiglu":
            self.w_gate = Linear(d_model, d_ff, dtype=dtype, device=device)
        self.w_up = Linear(d_model, d_ff, dtype=dtype, device=device)
        self.w_down = Linear(d_ff, d_model, dtype=dtype, device=device)

    def reset(self, generator):
        if self.act == "swiglu":
            self.w_gate.reset(generator)
        self.w_up.reset(generator)
        self.w_down.reset(generator)

    def forward(self, x):
        up = self.w_up(x)
        if self.act == "swiglu":
            hidden = F.silu(self.w_gate(x)) * up
        else:
            hidden = F.gelu(up, approximate="tanh")
        return self.w_down(hidden)
