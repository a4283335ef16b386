"""The LM train step (port of ``repro.train.steps``): the loss, the
train state, gradient accumulation and the NaN guard.

Layout, as the reference's: parameters in fp32 (the model's
``param_dtype``), compute in the model's ``compute_dtype`` through casts
at each use, gradients in the parameters' type, micro-batches summed in
``cfg.grad_dtype``. The parameters are the model's own tensors: the train
state's ``params`` names them, and the optimizer updates them in place.
Nothing in a step waits for the card: the metrics are device tensors.

The reference's sharded forms (``train_state_specs``, ``batch_specs``,
and ``make_train_step``'s cross-pod ``compression=``) come with the
multi-GPU slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.train.loss import chunked_softmax_xent

_MODULE_8 = "the multi-GPU slice (ROADMAP module 8)"


def make_loss_fn(model, cfg, xent_chunk: int = 256):
    """``loss_fn(batch) -> (loss, {"nll", "aux", "tokens"})``: the chunked
    cross-entropy of ``model`` on ``batch["tokens"]`` against
    ``batch["labels"]``, plus 0.01 times the MoE load-balancing loss;
    ``batch["context"]`` (a VLM's image tokens) and ``batch["frames"]``
    (an encoder-decoder's audio frames) go to the model as extras."""
    def loss_fn(batch):
        extras = {k: batch[k] for k in ("context", "frames") if k in batch}
        h, aux, _ = model.hidden(batch["tokens"], extras)
        nll, count = chunked_softmax_xent(
            h, model.unembed_weight(), batch["labels"],
            real_vocab=cfg.vocab_size, chunk=xent_chunk)
        loss = nll + 0.01 * aux
        return loss, {"nll": nll, "aux": aux, "tokens": count}

    return loss_fn


def init_train_state(model, optimizer, device="cuda") -> dict:
    """Turn ``model``'s parameters trainable and start the optimizer:
    ``{"params": {name: the model's parameter}, "opt": optimizer.init(...),
    "step": int32 0}``. ``device`` (default CUDA, which raises where there
    is none) must be where the model lies."""
    dev = resolve_device(device)
    params = dict(model.named_parameters())
    for name, p in params.items():
        if p.device.type != dev.type:
            raise ValueError(f"{name} lies on {p.device}, the train state "
                             f"on {dev}")
        p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def decayed(model) -> set:
    """The parameters that take AdamW's weight decay in the reference's
    LM training: its leaves of two or more dimensions, and its block
    parameters are stacked over the blocks, one axis more than the
    port's per-block tensors. So every parameter of a block (its norms'
    scales and the RWKV mixes and decays too) and the matrices outside
    the blocks."""
    return {n for n, p in model.named_parameters()
            if p.dim() >= 2 or ".blocks." in f".{n}"}


def train_state_specs(*args, **kwargs):
    raise NotImplementedError(f"train_state_specs: sharded train states "
                              f"come with {_MODULE_8}")


def batch_specs(*args, **kwargs):
    raise NotImplementedError(f"batch_specs: sharded batches come with "
                              f"{_MODULE_8}")


def make_grad_fn(model, cfg, grad_accum: int = 1, xent_chunk: int = 256):
    """``grads(params, batch) -> (loss, metrics, grads)``, the first half
    of a train step: ``batch`` holds ``grad_accum`` micro-batches along
    its leading axis; each one's gradients (``torch.autograd.grad`` of the
    loss, zeros for a parameter it does not reach) are summed in
    ``cfg.grad_dtype`` and divided by ``grad_accum``, and the loss and
    metrics are the micro-batches' means. With one micro-batch the
    gradients stay in the parameters' type."""
    loss_fn = make_loss_fn(model, cfg, xent_chunk)

    def value_and_grad(params, batch):
        loss, metrics = loss_fn(batch)
        tensors = list(params.values())
        got = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), got)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def grads(params, batch):
        if grad_accum <= 1:
            return value_and_grad(params, batch)
        gdt = getattr(torch, cfg.grad_dtype)
        gsum = {n: torch.zeros(p.shape, dtype=gdt, device=p.device)
                for n, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        per = []
        for i in range(grad_accum):
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + tuple(v.shape[1:]))[i]
                     for k, v in batch.items()}
            loss, metrics, g = value_and_grad(params, micro)
            for n, t in g.items():
                gsum[n].add_(t.to(gdt))
            del g
            lsum = lsum + loss
            per.append(metrics)
        for t in gsum.values():
            t.div_(grad_accum)
        metrics = {k: torch.stack([m[k] for m in per]).mean(0)
                   for k in per[0]}
        return lsum / grad_accum, metrics, gsum

    return grads


def _on(x, device) -> torch.Tensor:
    """A batch array on ``device``: numpy wrapped where it lies, then one
    copy to the device (no host tensor is made for it first)."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) \
        else torch.as_tensor(x)
    return t.to(device)


def make_train_step(model, cfg, optimizer, grad_accum: int = 1,
                    nan_guard: bool = True, compression=None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch``: ``{"tokens", "labels"}`` (accum * micro_B, S), and
    ``"context"`` or ``"frames"`` where the model takes them, as tensors
    or numpy arrays (copied to the model's device). The state is updated
    in place and returned. Metrics, device tensors: ``loss``, ``nll``,
    ``aux``, ``tokens``, ``grad_norm``, ``lr`` and, with ``nan_guard``,
    ``skipped``: a step whose loss or gradient norm is not finite keeps
    the parameters and moments as they were (``torch.where`` on the card,
    no host synchronisation); ``step`` counts it all the same."""
    if compression is not None:
        raise NotImplementedError(f"compression={compression!r}: the "
                                  f"cross-pod gradient reduction comes "
                                  f"with {_MODULE_8}")
    grads_of = make_grad_fn(model, cfg, grad_accum)
    decay = decayed(model)

    def step(state, batch):
        batch = {k: _on(v, model.device) for k, v in batch.items()}
        params = state["params"]
        loss, metrics, grads = grads_of(params, batch)
        _, _, opt_metrics = optimizer.update(
            grads, state["opt"], params, loss=loss if nan_guard else None,
            decay=decay)
        del grads
        state["step"] = state["step"] + 1
        return state, dict(metrics, loss=loss, **opt_metrics)

    return step
