"""QP policies (port of ``repro.engine.policies``): AccMPEG and the
uniform-QP building block. A policy maps chunk state to per-macroblock QP
maps; the :class:`~repro_torch.engine.engine.StreamingEngine` owns the
rest. Protocol: ``name``, ``reset()``, ``warm(engine, chunk)``,
``encode_chunk(ctx) -> decoded frames the server sees``."""
from __future__ import annotations

import torch

from repro_torch.codec.codec import encode_chunk_uniform
from repro_torch.codec.dct import MB
from repro_torch.core.quality import QualityConfig, qp_map_from_scores
from repro_torch.engine.engine import (ChunkContext, StreamingEngine,
                                       jit_encode, synchronize)


def warm_ready(device: torch.device, *thunks):
    """Run each warm-up thunk and wait for the device; returns the last
    result. On CUDA the first call of a kernel-backed encoder builds the
    kernel library, so nvcc time stays out of every measured chunk."""
    out = None
    for thunk in thunks:
        out = thunk()
    synchronize(device)
    return out


def frame_diff_feature(chunk: torch.Tensor) -> torch.Tensor:
    """Reducto's per-frame change feature: chunk (T, H, W, C) -> (T,), the
    first frame 1 and each later one ten times its mean absolute grey
    difference to its predecessor. (The ``0 * gx`` term is the reference's
    edge term, kept so that a non-finite frame poisons the feature as it
    does there.)"""
    gray = chunk.mean(-1)
    gx = torch.diff(gray, dim=2).abs().mean(dim=(1, 2))
    d = torch.diff(gray, dim=0).abs().mean(dim=(1, 2))
    one = torch.ones(1, dtype=d.dtype, device=d.device)
    return torch.cat([one, d * 10.0]) + 0 * gx


def soft_drop_previous(chunk: torch.Tensor, drop_thresh):
    """Frame drop at a fixed shape: frames whose change feature
    (:func:`frame_diff_feature`) falls below ``drop_thresh`` are replaced
    by the previous kept frame rather than removed, so the encode shape
    never changes (the repeated P-frame residual quantizes to ~0 bits).
    ``drop_thresh`` may be a tensor on the chunk's device, which is never
    read on the host. Frame 0 always survives. Returns (chunk, keep)."""
    T = chunk.shape[0]
    keep = frame_diff_feature(chunk) >= drop_thresh
    keep = torch.cat([torch.ones_like(keep[:1]), keep[1:]])
    idx = torch.arange(T, device=chunk.device)
    last_kept = torch.cummax(torch.where(keep, idx, -1), dim=0).values
    return chunk[last_kept], keep


class QPPolicy:
    """Base class; subclasses override encode_chunk (and usually warm)."""

    name = "policy"

    def reset(self):
        pass

    def warm(self, engine: StreamingEngine, chunk):
        pass

    def encode_chunk(self, ctx: ChunkContext):
        raise NotImplementedError


class AccMPEGPolicy(QPPolicy):
    """The paper's camera loop: AccModel once every ``frame_sample`` frames
    (default = chunk size), two-level QP map from the scores (§4).
    ``masks`` keeps each chunk's high-quality mask for inspection."""

    name = "accmpeg"

    def __init__(self, accmodel, qcfg: QualityConfig = QualityConfig(),
                 frame_sample=None):
        self.accmodel = accmodel
        self.qcfg = qcfg
        self.frame_sample = frame_sample
        self.masks = []

    def reset(self):
        self.masks = []

    def warm(self, engine, chunk):
        cs = engine.chunk_size
        k = self.frame_sample or cs
        n_maps = cs if k < cs else 1
        shape = (n_maps,) + tuple(s // MB for s in chunk.shape[1:3])
        warm_ready(
            engine.device,
            lambda: self.accmodel.scores(chunk[:1]),
            lambda: jit_encode(engine.impl)(
                chunk, torch.full(shape, 35.0, device=chunk.device)))

    def encode_chunk(self, ctx):
        chunk = ctx.chunk
        cs = ctx.engine.chunk_size
        k = self.frame_sample or cs

        def scores_fn():
            if k >= cs:
                return self.accmodel.scores(chunk[:1])
            s = self.accmodel.scores(chunk[::k])  # every k-th frame
            return s.repeat_interleave(k, dim=0)[:cs]

        scores = ctx.time_overhead(scores_fn)
        qmaps, masks = qp_map_from_scores(scores, self.qcfg)
        self.masks.append(masks)
        return ctx.encode(qmaps)


class UniformPolicy(QPPolicy):
    """AWStream-idealized building block: one uniform QP."""

    def __init__(self, qp: int, name=None):
        self.qp = qp
        self.name = name or f"uniform_qp{qp}"

    def warm(self, engine, chunk):
        warm_ready(engine.device, lambda: encode_chunk_uniform(chunk, self.qp))

    def encode_chunk(self, ctx):
        return ctx.encode_uniform(self.qp)
