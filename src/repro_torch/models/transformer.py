"""The LM stack (port of ``repro.models.transformer``).

A model is ``n_blocks`` repetitions of a super-block, a tuple of (mixer,
ffn) sublayers from the config's ``block_pattern``; a Python loop over
the blocks stands in for the reference's ``lax.scan``. Every mixer kind
of the reference is ported: ATTN (causal, or not in an encoder), XATTN
(cross-attention over ``extras["context"]``, the VLM's image tokens),
MAMBA and RWKV; so are the FFNs, MLP, MoE and the RWKV channel-mix of an
RWKV sublayer. A ``Stack`` built ``with_cross`` (the encoder-decoder's
decoder, ``models.encdec``) follows each mixer with a cross-attention
over the encoder's output.

API, as the reference's with the parameters held by the module:
    hidden(tokens, extras) -> (h, aux, kvs)     logits(h) -> (B, S, V)
    unembed_weight() -> (d, V)
    prefill(tokens, extras, max_seq) -> (cache, last_logits)
    decode(cache, token, pos) -> (cache, logits)
    init_cache(batch, seq)              pad_cache(kvs, prefill_len, max_seq)

``hidden`` and ``logits`` are differentiable (``repro_torch.train``
trains through them, each block checkpointed as ``cfg.remat`` says);
the serving calls run under ``torch.no_grad``. Parameters are created
frozen; ``train.steps.init_train_state`` turns them trainable.

A cache is a list with one entry per block, ``{"sub0": {"mixer": {"k",
"v"}, {"conv", "ssm"} or {"shift", "wkv"}, "cross": {"k", "v"}, "ffn":
{"shift"}}}`` as the reference's tree without its leading block axis;
with ``kv_cache_dtype="int8"`` each of "k" and "v" is the reference's
``{"q": int8, "s": fp32 (..., 1)}``. An XATTN sublayer's "k" and "v",
and a ``with_cross`` sublayer's "cross", hold the context's positions,
written once by the prefill and read whole by every step.
``decode`` writes the new token's K/V into the self-attention buffers in
place and replaces the recurrent states. Its ``pos`` is an int, or a
one-element int32 tensor on the model's device that the step reads on the
card (``repro_torch.launch.serve`` captures such a step once as a CUDA
graph).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, MAMBA, MLP, MOE, NOFF, RWKV,
                                      XATTN, ArchConfig)
from repro_torch.models import layers as L
from repro_torch.models.mamba import Mamba
from repro_torch.models.moe import MoE
from repro_torch.models.rwkv6 import RWKV6ChannelMix, RWKV6TimeMix


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, module "
                               f"9); the port runs ATTN, XATTN, MAMBA and "
                               f"RWKV mixers with MLP, MoE or channel-mix "
                               f"FFNs")


def _mixer_module(cfg: ArchConfig, kind: str, dtype, device,
                  causal: bool = True):
    if kind in (ATTN, XATTN):
        cross = kind == XATTN
        return L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           qkv_bias=cfg.qkv_bias,
                           rope_theta=0.0 if cross else cfg.rope_theta,
                           causal=causal, cross=cross, dtype=dtype,
                           device=device)
    if kind == MAMBA:
        return Mamba(cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv,
                     cfg.mamba_expand, cfg.mamba_dt_rank, dtype=dtype,
                     device=device)
    if kind == RWKV:
        return RWKV6TimeMix(cfg.d_model, cfg.rwkv_head_size,
                            cfg.rwkv_decay_lora, cfg.rwkv_gate_lora,
                            dtype=dtype, device=device)
    raise _unported(f"the {kind!r} mixer")


def _ffn_module(cfg: ArchConfig, mixer_kind: str, kind: str, dtype, device):
    if kind == NOFF:
        if mixer_kind == RWKV:
            return RWKV6ChannelMix(cfg.d_model, cfg.d_ff, dtype=dtype,
                                   device=device)
        return None
    if kind == MLP:
        return L.MLP(cfg.d_model, cfg.d_ff, act=cfg.act, dtype=dtype,
                     device=device)
    if kind == MOE:
        return MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                   cfg.capacity_factor, dtype=dtype, device=device)
    raise _unported(f"the {kind!r} FFN")


# the matrix products without batch dimensions (``x @ w`` reaches the
# dispatcher as ``mm`` on the flattened rows), the saves of the reference's
# ``checkpoint_dots_with_no_batch_dims``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(remat: str) -> dict:
    """``torch.utils.checkpoint`` arguments for a block under the config's
    ``remat``: "full" saves only the block's inputs and recomputes the rest
    in the backward, "dots" also saves its matrix products. No layer draws
    random numbers, so the checkpoints keep no generator state."""
    if remat == "full":
        return {}
    if remat == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"remat {remat!r} is not one of none, full, dots")


def _pad_seq(t, pad: int):
    """A K/V buffer (or the int8 form's ``q`` and ``s``) padded with
    ``pad`` zero positions along axis 1."""
    if isinstance(t, dict):
        return {n: _pad_seq(x, pad) for n, x in t.items()}
    return F.pad(t, (0, 0, 0, 0, 0, pad))


class SubLayer(nn.Module):
    """Pre-norm mixer and FFN with residuals: one (mixer, ffn) pair of the
    block pattern; with ``with_cross`` a pre-norm cross-attention over the
    context (``norm_x``, ``cross``) between the two. ``causal=False``
    makes an ATTN mixer attend every position (an encoder's)."""

    def __init__(self, cfg: ArchConfig, mixer_kind, ffn_kind, dtype, device,
                 causal: bool = True, with_cross: bool = False):
        super().__init__()
        self.mixer_kind = mixer_kind
        self.kv_int8 = cfg.kv_cache_dtype == "int8"
        self.norm1 = L.Norm(cfg.d_model, cfg.norm, device=device)
        self.mixer = _mixer_module(cfg, mixer_kind, dtype, device, causal)
        if with_cross:
            self.norm_x = L.Norm(cfg.d_model, cfg.norm, device=device)
            self.cross = _mixer_module(cfg, XATTN, dtype, device)
        else:
            self.norm_x = self.cross = None
        ffn = _ffn_module(cfg, mixer_kind, ffn_kind, dtype, device)
        if ffn is not None:
            self.norm2 = L.Norm(cfg.d_model, cfg.norm, device=device)
            self.ffn = ffn
        else:
            self.norm2 = self.ffn = None

    def reset(self, generator):
        for m in (self.norm1, self.mixer, self.norm_x, self.cross,
                  self.norm2, self.ffn):
            if m is not None:
                m.reset(generator)

    def _kv(self, k, v):
        """A K/V pair as the cache holds it (quantized for the int8
        form; this layer's only, never all layers')."""
        if self.kv_int8:
            k, v = L.quantize_kv(k), L.quantize_kv(v)
        return {"k": k, "v": v}

    def _ffn(self, x, state):
        """x + ffn(norm2(x)), the FFN's new state (channel-mix) or None,
        and its load-balancing loss (MoE) or None."""
        if self.ffn is None:
            return x, None, None
        h = self.norm2(x)
        if isinstance(self.ffn, RWKV6ChannelMix):
            o, st = self.ffn(h, state=state)
            return x + o, st, None
        if isinstance(self.ffn, MoE):
            o, (aux, _drop) = self.ffn(h)
            return x + o, None, aux
        return x + self.ffn(h), None, None

    def forward(self, x, collect_kv: bool, context=None):
        """Full sequence (``context`` (B, Sk, d) for an XATTN mixer or the
        cross-attention): (x, the MoE's load-balancing loss or None, this
        sublayer's cache entry or None)."""
        kv = {}
        h = self.norm1(x)
        if self.mixer_kind in (ATTN, XATTN):
            o, kv_pair = self.mixer(h, context=context, return_kv=collect_kv)
            if collect_kv:
                kv["mixer"] = self._kv(*kv_pair)
        else:
            o, kv["mixer"] = self.mixer(h)
        x = x + o
        if self.cross is not None:
            o, kv_pair = self.cross(self.norm_x(x), context=context,
                                    return_kv=collect_kv)
            if collect_kv:
                kv["cross"] = self._kv(*kv_pair)
            x = x + o
        x, st, aux = self._ffn(x, None)
        if st is not None:
            kv["ffn"] = st
        return x, aux, kv if collect_kv else None

    def decode(self, x, cache, pos):
        """One token x (B, 1, d) at ``pos`` (an int or a device tensor) ->
        (x, new cache entry)."""
        nc = {}
        h = self.norm1(x)
        if self.mixer_kind in (ATTN, XATTN):
            c = cache["mixer"]
            o, k, v = self.mixer.decode(h, c["k"], c["v"], pos)
            nc["mixer"] = {"k": k, "v": v}
        else:
            o, nc["mixer"] = self.mixer(h, state=cache["mixer"])
        x = x + o
        if self.cross is not None:
            c = cache["cross"]
            o, k, v = self.cross.decode(self.norm_x(x), c["k"], c["v"], pos)
            nc["cross"] = {"k": k, "v": v}
            x = x + o
        x, st, _aux = self._ffn(x, cache.get("ffn"))
        if st is not None:
            nc["ffn"] = st
        return x, nc


class Stack(nn.Module):
    """``n_blocks`` super-blocks of sublayers ``sub0``, ``sub1``, ...;
    ``causal=False`` for an encoder's, ``with_cross`` for the
    encoder-decoder's decoder (a cross-attention in every sublayer). The
    default device is CUDA, which raises where there is none."""

    def __init__(self, cfg: ArchConfig, compute_dtype=torch.bfloat16,
                 param_dtype=torch.float32, device="cuda",
                 causal: bool = True, with_cross: bool = False):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        device = resolve_device(device)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"sub{i}": SubLayer(cfg, m, f, param_dtype,
                                               device, causal, with_cross)
                           for i, (m, f) in enumerate(cfg.block_pattern)})
            for _ in range(cfg.n_blocks))

    def reset(self, generator):
        for block in self.blocks:
            for sub in block.values():
                sub.reset(generator)

    @staticmethod
    def _block(block, x, total, context, collect_kv: bool):
        kv = {}
        for name, sub in block.items():
            x, aux, kv[name] = sub(x, collect_kv, context)
            if aux is not None:
                total = total + aux
        return x, total, kv

    def forward(self, x, extras=None, collect_kv: bool = False):
        """x (B, S, d), ``extras["context"]`` (B, Sk, d) for the XATTN
        sublayers or the cross-attentions -> (x, the MoE sublayers'
        load-balancing losses summed in block order (fp32, 0 without
        MoE), per-block caches or None).

        Where autograd records this call (grad mode on and the stack's
        parameters requiring gradients), each block runs under
        ``torch.utils.checkpoint`` as the config's ``remat`` says (the
        reference's ``jax.checkpoint`` of its scanned block): "full"
        recomputes the block in the backward, "dots" keeps its matrix
        products, "none" keeps everything."""
        context = (extras or {}).get("context")
        remat = self.cfg.remat
        trained = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        if not trained or collect_kv:
            remat = "none"
        kw = {} if remat == "none" else _remat_kwargs(remat)
        kvs = []
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            if remat == "none":
                x, total, kv = self._block(block, x, total, context,
                                           collect_kv)
            else:
                x, total, kv = checkpoint(self._block, block, x, total,
                                          context, False,
                                          use_reentrant=False,
                                          preserve_rng_state=False, **kw)
            kvs.append(kv)
        return x, total, kvs if collect_kv else None

    def decode_step(self, x, cache, pos):
        """x (B, 1, d) at ``pos`` (an int or a device tensor) -> (x, new
        cache)."""
        new_cache = []
        for block, block_cache in zip(self.blocks, cache):
            nc = {}
            for name, sub in block.items():
                x, nc[name] = sub.decode(x, block_cache[name], pos)
            new_cache.append(nc)
        return x, new_cache

    def init_cache(self, batch: int, seq: int, ctx_len=None):
        """Zero buffers: ``seq`` positions of each self-attention layer,
        ``ctx_len`` (default the config's ``n_frontend_tokens``) of each
        XATTN layer and cross-attention, the recurrent states."""
        cfg, dev = self.cfg, self.blocks[0]["sub0"].norm1.scale.device
        ctx_len = cfg.n_frontend_tokens if ctx_len is None else ctx_len

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def kv(n):
            shape = (batch, n, cfg.n_kv_heads, cfg.hd)
            if cfg.kv_cache_dtype == "int8":
                return {t: {"q": zeros(*shape, dtype=torch.int8),
                            "s": zeros(*shape[:-1], 1)} for t in "kv"}
            return {t: zeros(*shape, dtype=self.compute_dtype) for t in "kv"}

        cache = []
        for block in self.blocks:
            c = {}
            for name, sub in block.items():
                m = sub.mixer
                if sub.mixer_kind in (ATTN, XATTN):
                    e = {"mixer": kv(seq if sub.mixer_kind == ATTN
                                     else ctx_len)}
                elif sub.mixer_kind == MAMBA:
                    e = {"mixer": {
                        "conv": zeros(batch, m.d_conv - 1, m.d_inner),
                        "ssm": zeros(batch, m.d_inner, m.d_state)}}
                else:
                    hd = m.head_size
                    e = {"mixer": {"shift": zeros(batch, cfg.d_model),
                                   "wkv": zeros(batch, m.n_heads, hd, hd)}}
                if sub.cross is not None:
                    e["cross"] = kv(ctx_len)
                if isinstance(sub.ffn, RWKV6ChannelMix):
                    e["ffn"] = {"shift": zeros(batch, cfg.d_model)}
                c[name] = e
            cache.append(c)
        return cache

    def pad_cache(self, kvs, prefill_len: int, max_seq: int):
        """Pad the self-attention K/V collected at prefill out to
        ``max_seq`` tokens so that decode can keep writing (zeros, and for
        the int8 form zero ``q`` and zero ``s``); states and the context's
        K/V (XATTN layers, cross-attentions) pass through."""
        if max_seq < prefill_len:
            raise ValueError(f"max_seq {max_seq} < prefill length "
                             f"{prefill_len}")
        pad = max_seq - prefill_len
        if pad == 0:
            return kvs
        out = []
        for block, kv in zip(self.blocks, kvs):
            nb = {}
            for name, sub in block.items():
                e = dict(kv[name])
                if sub.mixer_kind == ATTN:
                    e["mixer"] = {n: _pad_seq(t, pad)
                                  for n, t in e["mixer"].items()}
                nb[name] = e
            out.append(nb)
        return out


class DecoderLM(nn.Module):
    """Decoder-only LM for the dense (ATTN + MLP), MoE (ATTN + MoE), RWKV,
    hybrid (MAMBA and ATTN with MLP and MoE) and VLM (ATTN and XATTN
    over image tokens, + MLP) families.

    Parameters are held in ``param_dtype`` (the reference's fp32 norm,
    mix, decay and bonus parameters stay fp32) and drawn at construction
    from ``generator`` by :meth:`init`. With ``init=False`` they are left
    unset for a caller that loads every one of them, as ``repro_torch.
    weights.lm_from_numpy`` does with the reference's parameters. The
    default device is CUDA, which raises where there is none."""

    def __init__(self, cfg: ArchConfig, compute_dtype=torch.bfloat16,
                 param_dtype=torch.float32, device="cuda", generator=None,
                 init: bool = True):
        super().__init__()
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"with repro_torch.models.EncDecLM")
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.device = resolve_device(device)
        dev = self.device
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, param_dtype,
                                 device=dev)
        self.stack = Stack(cfg, compute_dtype, param_dtype, device=dev)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, device=dev)
        self.lm_head = None if cfg.tie_embeddings else L.Linear(
            cfg.d_model, cfg.padded_vocab, dtype=param_dtype, device=dev)
        if init:
            self.init(generator)

    @torch.no_grad()
    def init(self, generator=None):
        """Draw every parameter from the reference's distributions: Linear
        weights N(0, 1/d_in), the embedding N(0, 0.02^2), norms at 1 and 0,
        the RWKV mixes, decays and bonus as ``RWKV6TimeMix.reset``, and
        Mamba's as ``Mamba.reset``.
        The two packages' generators differ, so the values do too."""
        for m in (self.embed, self.stack, self.final_norm, self.lm_head):
            if m is not None:
                m.reset(generator)
        return self

    # ---- forward ----------------------------------------------------------
    def _extras(self, extras):
        extras = dict(extras or {})
        if self.cfg.cross_attn_every and "context" not in extras:
            raise ValueError(f"{self.cfg.name} needs extras['context'] "
                             f"(frontend stub)")
        return extras

    def hidden(self, tokens, extras=None, collect_kv: bool = False):
        """tokens (B, S) int; ``extras["context"]`` (B, n_frontend_tokens,
        d), the image tokens a VLM's XATTN layers attend (required there)
        -> (h (B, S, d), the MoE sublayers' summed load-balancing loss (0
        without MoE), kvs). Differentiable: autograd records it where the
        parameters require gradients (``train.steps.init_train_state``
        turns them on) and grad mode is on."""
        extras = self._extras(extras)
        x = self.embed(tokens, self.compute_dtype)
        x, aux, kvs = self.stack(x, extras, collect_kv=collect_kv)
        x = self.final_norm(x)
        return x, aux, kvs

    def unembed_weight(self):
        """The (d, V_padded) unembedding: the tied embedding's transpose,
        or the LM head's weight."""
        if self.lm_head is None:
            return self.embed.emb.T
        return self.lm_head.w

    def logits(self, h):
        """The tied embedding's ``attend``, or the LM head."""
        if self.lm_head is None:
            return self.embed.attend(h)
        return self.lm_head(h)

    # ---- serving ----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens, extras=None, max_seq=None):
        """-> (cache, logits of the last position (B, 1, V)); the
        self-attention K/V buffers hold ``max_seq`` tokens (default: the
        prompt's length), the XATTN layers' the context's K/V."""
        h, _aux, kvs = self.hidden(tokens, extras, collect_kv=True)
        if max_seq is not None:
            kvs = self.stack.pad_cache(kvs, tokens.shape[1], max_seq)
        return kvs, self.logits(h[:, -1:, :])

    def init_cache(self, batch: int, seq: int):
        return self.stack.init_cache(batch, seq)

    def pad_cache(self, kvs, prefill_len: int, max_seq: int):
        return self.stack.pad_cache(kvs, prefill_len, max_seq)

    @torch.no_grad()
    def decode(self, cache, token, pos):
        """token (B, 1) int; pos: its position, an int or a one-element
        int32 tensor on the model's device -> (cache, logits (B, 1, V)).
        A tensor ``pos`` is read on the card, unchecked: the caller keeps
        it inside the cache."""
        if not isinstance(pos, torch.Tensor):
            pos = int(pos)
        x = self.embed(token, self.compute_dtype)
        x, cache = self.stack.decode_step(x, cache, pos)
        return cache, self.logits(self.final_norm(x))
