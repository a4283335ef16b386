"""Each dry-run cell's step and inputs on meta tensors (the counterpart of
``repro.launch.specs``).

``build_cell(arch, shape_name)`` builds the port's train, prefill or
decode step of one (arch x workload shape) cell on
``torch.device("meta")``: the model, its state and its inputs have shapes
and types and no memory, so a cell of any size builds on any host, and
:mod:`repro_torch.launch.analysis` counts it. The reference shards each
cell over a TPU mesh; here the mesh is the one card, so there are no
shardings, and a multi-pod mesh raises (ROADMAP module 8). The steps are
the eager ones (``train.steps.make_train_step``, ``serve.steps``' prefill
and decode steps), not ``launch.serve.DecodeGraph``'s captured graph.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeSpec,
                                      cell_applicable, get_config)
from repro_torch.optim.adamw import AdamW, warmup_cosine

META = torch.device("meta")
MESHES = ("single",)  # the one card; the reference's "multi" is module 8


def _no_multi(mesh: str):
    if mesh not in MESHES:
        raise NotImplementedError(
            f"mesh {mesh!r}: multi-pod meshes come with the multi-GPU "
            f"slice (ROADMAP module 8); the port's dry-run runs on one "
            f"card (mesh 'single')")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable
    args: tuple  # meta tensors (and a decode step's int position)
    model: torch.nn.Module
    meta: dict

    @property
    def roots(self) -> tuple:
        """What is alive as the step starts beside its arguments: the
        model's parameters and buffers (and, in a train state, the
        optimizer's moments, which the arguments hold)."""
        return (list(self.model.parameters()), list(self.model.buffers()))


def make_optimizer(cfg: ArchConfig) -> AdamW:
    return AdamW(schedule=warmup_cosine(3e-4, 2000, 200_000),
                 moment_dtype=getattr(torch, cfg.opt_moment_dtype))


def _seq_lens(cfg: ArchConfig, shape: ShapeSpec):
    """(token_len, frontend_len): enc-dec cells split the budget 50/50 for
    train/prefill; decode cells keep the full-length cross stream."""
    if cfg.enc_dec:
        if shape.kind == "decode":
            return shape.seq_len, shape.seq_len
        return shape.seq_len // 2, shape.seq_len // 2
    return shape.seq_len, cfg.n_frontend_tokens


def _model(cfg: ArchConfig, param_dtype, device):
    """The LM on ``device``: parameters left unset on meta, drawn from a
    seeded generator elsewhere."""
    from repro_torch.models import DecoderLM, EncDecLM

    real = device.type != "meta"
    return (EncDecLM if cfg.enc_dec else DecoderLM)(
        cfg, compute_dtype=torch.bfloat16, param_dtype=param_dtype,
        device=device, init=real,
        generator=torch.Generator(device).manual_seed(0) if real else None)


def _extras(cfg: ArchConfig, B: int, front_len: int, device) -> dict:
    """A VLM's image tokens or an encoder-decoder's frames, bf16 zeros."""
    shape = (B, front_len, cfg.d_model)
    if cfg.cross_attn_every:
        return {"context": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device)}
    if cfg.enc_dec:
        return {"frames": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)}
    return {}


def _tokens(B: int, S: int, device):
    return torch.zeros((B, S), dtype=torch.int32, device=device)


def train_micro_batches(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """A train cell's micro-batches: on one card every micro-batch is on
    it, at most one per sequence."""
    return max(1, min(cfg.grad_accum, shape.global_batch))


def build_cell(arch: str, shape_name: str, cfg: Optional[ArchConfig] = None,
               mesh: str = "single", device=META,
               blocks: Optional[int] = None,
               micro_batches: Optional[int] = None) -> Cell:
    """The cell's step ``fn(*args)`` on meta tensors: train (fp32 or the
    config's master parameters, bf16 compute, AdamW with the config's
    moment type, :func:`train_micro_batches` micro-batches), prefill (bf16
    weights, the prompt's length of cache) or one decode step (bf16
    weights, a cache of ``seq_len`` positions, at its last position).
    Another ``device`` builds the same step on real tensors (seeded
    weights, zero tokens), for a test to run it.

    ``blocks`` and ``micro_batches`` build a prefix of the step for
    :func:`repro_torch.launch.analysis.count_cell`: its first ``blocks``
    super-blocks, and ``micro_batches`` micro-batches of the cell's size
    (the global batch scaled to match)."""
    _no_multi(mesh)
    device = torch.device(device)
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell skipped: {why}")
    if blocks is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=blocks * len(cfg.block_pattern))
    B = shape.global_batch
    tok_len, front_len = _seq_lens(cfg, shape)

    if shape.kind == "train":
        from repro_torch.train.steps import init_train_state, make_train_step

        model = _model(cfg, getattr(torch, cfg.param_dtype), device)
        opt = make_optimizer(cfg)
        state = init_train_state(model, opt, device)
        accum = train_micro_batches(cfg, shape)
        if micro_batches is not None:
            B, accum = B // accum * micro_batches, micro_batches
        batch = {"tokens": _tokens(B, tok_len, device),
                 "labels": _tokens(B, tok_len, device),
                 **_extras(cfg, B, front_len, device)}
        fn = make_train_step(model, cfg, opt, grad_accum=accum)
        return Cell(arch, shape, fn, (state, batch), model,
                    meta={"tok_len": tok_len, "kind": "train",
                          "grad_accum": accum})

    from repro_torch.serve.steps import make_decode_step, make_prefill_step

    model = _model(cfg, torch.bfloat16, device)  # serving: bf16 weights
    if shape.kind == "prefill":
        batch = {"tokens": _tokens(B, tok_len, device),
                 **_extras(cfg, B, front_len, device)}
        fn = make_prefill_step(model, cfg)
        return Cell(arch, shape, fn, (batch,), model,
                    meta={"tok_len": tok_len, "kind": "prefill"})

    # decode: one new token against a seq_len cache
    cache = model.init_cache(B, shape.seq_len)
    fn = make_decode_step(model, cfg)
    return Cell(arch, shape, fn,
                (cache, _tokens(B, 1, device), shape.seq_len - 1),
                model, meta={"tok_len": shape.seq_len, "kind": "decode"})


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for train;
    2*N*D for prefill; 2*N_active per token for decode. Enc-dec cells split
    the token budget 50/50 between the stacks, so the effective token count
    halves (each token passes through ~half the parameters)."""
    n_active = cfg.active_param_count()
    tokens = shape.tokens * (0.5 if cfg.enc_dec else 1.0)
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # one token per sequence
