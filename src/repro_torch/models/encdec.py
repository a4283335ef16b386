"""Encoder-decoder LM, the seamless-m4t family (port of
``repro.models.encdec``).

The speech frontend is a stub, as in the reference: the encoder takes
precomputed audio-frame embeddings (``extras["frames"]``, (B, enc_len,
d)). Sinusoidal positions go onto the frames and onto the decoder's
tokens (at ``pos`` in decode). The encoder is a non-causal stack; the
decoder a causal one whose sublayers each attend the encoder's output
through a cross-attention. The prefill writes every decoder layer's
cross K/V once (``cache[b]["sub0"]["cross"]``); each decode step reads
them whole and attends its own self-attention cache up to ``pos``.

The model has :class:`~repro_torch.models.DecoderLM`'s serving API and its
``cfg`` and ``device`` attributes, so that ``serve.steps`` and
``launch.serve`` (``serve_tokens``, ``DecodeGraph``) take it as they are.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import Stack


class EncDecLM(nn.Module):
    """Parameters as the reference's tree: ``embed``, ``encoder`` and
    ``decoder`` (each a :class:`Stack`, the decoder's built
    ``with_cross``), ``enc_norm``, ``final_norm`` and an untied
    ``lm_head``; drawn at construction from ``generator`` (``init=False``
    leaves them for a loader, ``repro_torch.weights.lm_from_numpy``). The
    default device is CUDA, which raises where there is none."""

    def __init__(self, cfg: ArchConfig, compute_dtype=torch.bfloat16,
                 param_dtype=torch.float32, device="cuda", generator=None,
                 init: bool = True):
        super().__init__()
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder: build "
                             f"it with repro_torch.models.DecoderLM")
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.device = dev = resolve_device(device)
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, param_dtype,
                                 device=dev)
        self.encoder = Stack(cfg, compute_dtype, param_dtype, device=dev,
                             causal=False)
        self.decoder = Stack(cfg, compute_dtype, param_dtype, device=dev,
                             with_cross=True)
        self.enc_norm = L.Norm(cfg.d_model, cfg.norm, device=dev)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, device=dev)
        self.lm_head = L.Linear(cfg.d_model, cfg.padded_vocab,
                                dtype=param_dtype, device=dev)
        if init:
            self.init(generator)

    @torch.no_grad()
    def init(self, generator=None):
        """Draw every parameter from the reference's distributions (see
        ``DecoderLM.init``); the two packages' generators differ, so the
        values do too."""
        for m in (self.embed, self.encoder, self.decoder, self.enc_norm,
                  self.final_norm, self.lm_head):
            m.reset(generator)
        return self

    def _positions(self, x, positions):
        return x + L.sinusoidal_positions(positions, self.cfg.d_model,
                                          x.dtype)[None]

    def encode(self, frames):
        """frames (B, enc_len, d), the frontend stub's embeddings -> (the
        normed encoder output (B, enc_len, d), the encoder's MoE loss)."""
        x = frames.to(self.compute_dtype)
        x = self._positions(x, torch.arange(x.shape[1], device=x.device))
        x, aux, _ = self.encoder(x)
        return self.enc_norm(x), aux

    def hidden(self, tokens, extras=None, collect_kv: bool = False):
        """tokens (B, S) int, ``extras["frames"]`` (B, enc_len, d) ->
        (h (B, S, d), the summed MoE loss, the decoder's kvs)."""
        extras = dict(extras or {})
        if "frames" not in extras:
            raise ValueError(f"{self.cfg.name} needs extras['frames'] "
                             f"(frontend stub)")
        enc_out, aux_e = self.encode(extras["frames"])
        x = self.embed(tokens, self.compute_dtype)
        x = self._positions(x, torch.arange(x.shape[1], device=x.device))
        x, aux_d, kvs = self.decoder(x, {"context": enc_out},
                                     collect_kv=collect_kv)
        return self.final_norm(x), aux_e + aux_d, kvs

    def unembed_weight(self):
        """The (d, V_padded) unembedding, the LM head's weight."""
        return self.lm_head.w

    def logits(self, h):
        return self.lm_head(h)

    # ---- serving ----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens, extras=None, max_seq=None):
        """-> (cache, logits of the last position (B, 1, V)): the decoder's
        self-attention buffers hold ``max_seq`` tokens (default: the
        prompt's length), its cross buffers the frames' K/V."""
        h, _aux, kvs = self.hidden(tokens, extras, collect_kv=True)
        if max_seq is not None:
            kvs = self.decoder.pad_cache(kvs, tokens.shape[1], max_seq)
        return kvs, self.logits(h[:, -1:, :])

    def init_cache(self, batch: int, seq: int):
        """Zero buffers, the cross ones ``seq`` positions long, as the
        reference's (its decode cells size the encoder stream to the
        cell's sequence)."""
        return self.decoder.init_cache(batch, seq, ctx_len=seq)

    def pad_cache(self, kvs, prefill_len: int, max_seq: int):
        return self.decoder.pad_cache(kvs, prefill_len, max_seq)

    @torch.no_grad()
    def decode(self, cache, token, pos):
        """token (B, 1) int; pos: its position, an int or a one-element
        int32 tensor on the model's device (read on the card, unchecked)
        -> (cache, logits (B, 1, V))."""
        x = self.embed(token, self.compute_dtype)
        if not isinstance(pos, torch.Tensor):
            pos = int(pos)
            posv = torch.full((1,), pos, device=x.device)
        else:
            posv = pos.reshape(1)
        x = self._positions(x, posv)
        x, cache = self.decoder.decode_step(x, cache, pos)
        return cache, self.logits(self.final_norm(x))
