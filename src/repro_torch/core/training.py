"""AccModel offline training (§5), port of ``repro.core.training``.

Two trainers, compared with each other in Table 2:

- ``train_accmodel`` (the paper's contribution, Fig. 5b): AccGrad labels
  once per image (2 forward + 1 backward through the final DNN), then the
  AccModel trains alone with weighted BCE (4x weight on positive blocks).
- ``train_accmodel_e2e`` (the conventional baseline, Fig. 5a): the
  differentiable pipeline X = M*H + (1-M)*L through the final DNN at
  every step.

Both run on the final DNN's device. The optimizer is the reference's own
Adam (:func:`adam_update`), not ``torch.optim.Adam``; batch order comes
from ``np.random.default_rng(seed)`` as in the reference, so both
packages see the same batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import synchronize
from repro_torch.codec.codec import encode_chunk_uniform
from repro_torch.codec.dct import MB
from repro_torch.core.accgrad import accgrad_frames
from repro_torch.core.accmodel import AccModel

ACCMODEL_LR = 1e-3
ACCMODEL_WARMUP = 20  # steps of linear learning-rate warm-up


@dataclasses.dataclass
class TrainReport:
    accmodel: AccModel
    label_time_s: float
    train_time_s: float
    losses: list
    epochs: int

    @property
    def total_time_s(self):
        return self.label_time_s + self.train_time_s


def accmodel_init(seed: int, width: int = 16, device="cuda") -> AccModel:
    """The trainers' initial AccModel: weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    return AccModel(width, torch.Generator().manual_seed(seed),
                    device=device)


def adam_state(params: Sequence[torch.Tensor]):
    """Zero first and second moments for ``params``."""
    return ([torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params])


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], m: List[torch.Tensor],
                v: List[torch.Tensor], t: int, lr: float, warmup: int):
    """One step of the reference's Adam, in place on ``params``, ``m``
    and ``v``: betas 0.9 / 0.99, no bias correction, epsilon outside the
    square root, learning rate ``lr * min(1, (t + 1) / warmup)`` at step
    ``t`` (counted across epochs)."""
    lr_t = lr * min(1.0, (t + 1) / warmup)
    for p, g, mm, vv in zip(params, grads, m, v):
        mm.copy_(0.9 * mm + 0.1 * g)
        vv.copy_(0.99 * vv + 0.01 * g * g)
        p.sub_(lr_t * mm / (vv.sqrt() + 1e-8))


def _uniform_pair(frames: np.ndarray, qp_hi: int, qp_lo: int, batch: int,
                  device):
    """Per batch of frames, coded as one chunk: (hq, lq) from the exact
    codec at ``qp_hi`` and ``qp_lo``."""
    for i in range(0, frames.shape[0], batch):
        chunk = torch.as_tensor(frames[i:i + batch], device=device)
        yield (encode_chunk_uniform(chunk, qp_hi)[0],
               encode_chunk_uniform(chunk, qp_lo)[0])


def make_labels(final_dnn, frames: np.ndarray, qp_hi: int, qp_lo: int,
                batch: int = 4, label_alpha: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AccGrad ground truth for a stack of frames (N, H, W, 3).

    Returns (hq_frames, binary labels (N, mb_h, mb_w)) on the final DNN's
    device. ``label_alpha`` binarizes the normalised AccGrad; a permissive
    threshold is right because false positives are cheap (§3.2) while a
    missed block costs accuracy.
    """
    hqs, labels = [], []
    for hq, lq in _uniform_pair(frames, qp_hi, qp_lo, batch,
                                final_dnn.device):
        hqs.append(hq)
        labels.append(accgrad_frames(final_dnn, hq, lq) >= label_alpha)
    return torch.cat(hqs), torch.cat(labels)


def weighted_bce(logits, labels, pos_weight: float = 4.0):
    """The paper's false-positive-tolerant loss: 4x weight on blocks that
    should be high quality (missing one hurts; extras are cheap, §3.2)."""
    labels = labels.to(torch.float32)
    logp = F.logsigmoid(logits)
    lognp = F.logsigmoid(-logits)
    return -(pos_weight * labels * logp + (1 - labels) * lognp).mean()


def _train(model: AccModel, n: int, batch: int, epochs: int, seed: int,
           loss_fn, device) -> Tuple[list, float]:
    """The shared loop: ``epochs`` passes over ``n`` items in the order of
    ``np.random.default_rng(seed)``, one Adam step per batch of indices
    (``loss_fn(idx)``). Returns the last batch's loss of each epoch and
    the seconds the loop took, the device's work included."""
    params = list(model.parameters())
    m, v = adam_state(params)
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.perf_counter()
    t = 0
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch):
            idx = torch.as_tensor(order[i:i + batch], device=device)
            loss = loss_fn(idx)
            grads = torch.autograd.grad(loss, params)
            adam_update(params, grads, m, v, t, ACCMODEL_LR, ACCMODEL_WARMUP)
            t += 1
        losses.append(float(loss.detach()))
    synchronize(device)
    return losses, time.perf_counter() - t0


def train_accmodel(final_dnn, frames: np.ndarray, *, qp_hi=30, qp_lo=40,
                   epochs: int = 15, batch: int = 4, width: int = 16,
                   seed: int = 0, pos_weight: float = 4.0,
                   label_alpha: float = 0.1) -> TrainReport:
    """The decoupled trainer (Fig. 5b)."""
    device = final_dnn.device
    t0 = time.perf_counter()
    hq, labels = make_labels(final_dnn, frames, qp_hi, qp_lo, batch,
                             label_alpha=label_alpha)
    synchronize(device)
    label_time = time.perf_counter() - t0

    model = accmodel_init(seed, width, device)
    losses, train_time = _train(
        model, hq.shape[0], batch, epochs, seed,
        lambda idx: weighted_bce(model(hq[idx]), labels[idx], pos_weight),
        device)
    model.name = f"accmodel-{final_dnn.name}"
    return TrainReport(model, label_time, train_time, losses, epochs)


def train_accmodel_e2e(final_dnn, frames: np.ndarray, *, qp_hi=30, qp_lo=40,
                       epochs: int = 15, batch: int = 4, width: int = 16,
                       seed: int = 0) -> TrainReport:
    """The conventional end-to-end trainer (Fig. 5a), Table 2's baseline.

    Every step: AccModel forward -> soft mask M -> X = M*H + (1-M)*L ->
    final DNN forward -> loss against D(H) -> backward through D *and*
    the AccModel; D(H) itself is recomputed every step, as the reference
    does (that cost is what Table 2 compares).
    """
    device = final_dnn.device
    t0 = time.perf_counter()
    pairs = list(_uniform_pair(frames, qp_hi, qp_lo, batch, device))
    hq_all = torch.cat([hq for hq, _ in pairs])
    lq_all = torch.cat([lq for _, lq in pairs])
    synchronize(device)
    prep_time = time.perf_counter() - t0

    model = accmodel_init(seed, width, device)

    def loss_fn(idx):
        hq, lq = hq_all[idx], lq_all[idx]
        ref = final_dnn.predict(hq)  # D forward (the conventional cost)
        msoft = torch.sigmoid(model(hq))  # the paper's softmax filter
        mpix = msoft.repeat_interleave(MB, dim=1).repeat_interleave(
            MB, dim=2)[..., None]
        return final_dnn.proxy_loss(mpix * hq + (1 - mpix) * lq, ref)

    losses, train_time = _train(model, hq_all.shape[0], batch, epochs, seed,
                                loss_fn, device)
    model.name = f"accmodel-e2e-{final_dnn.name}"
    return TrainReport(model, prep_time, train_time, losses, epochs)
