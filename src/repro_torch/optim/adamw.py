"""AdamW over flat dicts of tensors (port of ``repro.optim.adamw``).

The reference's arithmetic, tensor by tensor:

- the rate read from the schedule at ``count + 1``;
- global-norm clipping, ``min(1, clip_norm / max(norm, 1e-12))``;
- bias correction, and ``eps`` added to ``sqrt(v_hat)``;
- decoupled weight decay on tensors of two or more dimensions only
  (``update``'s ``decay`` names them where a caller's tensors are slices
  of the reference's: see ``train.steps.decayed``);
- moments held in ``moment_dtype`` (fp32 or bf16), or the second moment
  int8 block-quantized (``quantized_v``: absmax scales over blocks of
  :data:`QBLOCK` elements), all computed in fp32.

``torch.optim.AdamW`` decays every tensor and has no int8 moment, so the
port keeps its own. ``count``, the rate and the clipping scale stay
tensors on the parameters' device: an update makes no host
synchronisation. Parameters and moments are updated in place (the
reference returns new trees): rwkv6-1.6b's fp32 parameters and two moments
hold 19.2 GB, and a second copy of them would serve nothing.

The reference's ``spec`` and ``zero1_specs`` shard the moments over a
mesh; they come with the multi-GPU slice (ROADMAP module 8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional

import torch

QBLOCK = 256

Tensors = Dict[str, torch.Tensor]


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """The rate at ``step`` (a number or a tensor; fp32, on the tensor's
    device): linear from 0 over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``floor * base_lr`` at ``total``."""
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return sched


def tree_global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, as a tensor
    on the tensors' device (``repro.utils.tree_global_norm``)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def _quantize_blockwise(x: torch.Tensor):
    """int8 absmax quantization over trailing blocks of QBLOCK elements ->
    (q (nb, QBLOCK) int8, scale (nb, 1) fp32)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % QBLOCK))
    blocks = flat.reshape(-1, QBLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    quantized_v: bool = False  # int8 second moment

    def init(self, params: Tensors) -> dict:
        """Zero moments for ``params`` (name -> tensor) and ``count`` 0,
        on the parameters' device: {"m": {name: tensor}, "v": {name:
        tensor, or {"q", "scale"} when quantized}, "count": int32}."""
        def make_v(p):
            if self.quantized_v:
                nb = -(-p.numel() // QBLOCK)
                return {"q": torch.zeros((nb, QBLOCK), dtype=torch.int8,
                                         device=p.device),
                        "scale": torch.zeros((nb, 1), dtype=torch.float32,
                                             device=p.device)}
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)

        device = next(iter(params.values())).device
        return {"m": {n: torch.zeros(p.shape, dtype=self.moment_dtype,
                                     device=p.device)
                      for n, p in params.items()},
                "v": {n: make_v(p) for n, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors,
               loss: Optional[torch.Tensor] = None,
               decay: Optional[Iterable[str]] = None):
        """One step over ``params`` with ``grads`` (both name -> tensor),
        in place -> (params, state, metrics {"grad_norm", "lr"}). Given
        ``loss`` (the train step's NaN guard), the metrics also hold
        ``skipped`` (1.0 or 0.0) and nothing changes, the count included,
        unless both the loss and the gradient norm are finite: every
        tensor takes ``torch.where`` of its new and old values on the
        device. ``decay`` names the tensors that take weight decay
        (default: those of two or more dimensions; the LM's train step
        names those the reference's stacked tree gives two or more)."""
        count = state["count"] + 1
        lr = self.schedule(count)
        gnorm = tree_global_norm(grads[n] for n in params)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.pow(b1, count.to(torch.float32))
        bc2 = 1 - torch.pow(b2, count.to(torch.float32))
        decay = {n for n, p in params.items() if p.dim() >= 2} \
            if decay is None else set(decay)
        ok = None
        if loss is not None:
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)

        def commit(dst, new):
            dst.copy_(new if ok is None else torch.where(ok, new, dst))

        for name, p in params.items():
            g = grads[name].to(torch.float32) * scale
            m, v = state["m"][name], state["v"][name]
            new_m = b1 * m.to(torch.float32) + (1 - b1) * g
            if self.quantized_v:
                v32 = _dequantize_blockwise(v["q"], v["scale"], p.shape)
            else:
                v32 = v.to(torch.float32)
            new_v = b2 * v32 + (1 - b2) * torch.square(g)
            u = (new_m / bc1) / (torch.sqrt(new_v / bc2) + self.eps)
            if name in decay:  # decoupled, on matrices only
                u = u + self.weight_decay * p.to(torch.float32)
            commit(p, (p.to(torch.float32) - lr * u).to(p.dtype))
            commit(m, new_m.to(self.moment_dtype))
            if self.quantized_v:
                q, s = _quantize_blockwise(new_v)
                commit(v["q"], q)
                commit(v["scale"], s)
            else:
                commit(v, new_v.to(self.moment_dtype))
        commit(state["count"], count)
        metrics = {"grad_norm": gnorm, "lr": lr}
        if ok is not None:
            metrics["skipped"] = (~ok).to(torch.float32)
        return params, state, metrics
