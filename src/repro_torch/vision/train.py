"""Train the final DNNs on synthetic scenes (port of
``repro.vision.train``), cached under ``experiments/models_torch/``.

These stand in for the paper's pretrained models; the AccMPEG core only
sees them as black boxes. The cache is the port's own directory, never
the reference's ``experiments/models/``, and holds the reference's flat
npz form (``repro_torch.weights.final_dnn_to_numpy``), written to a
temporary file and moved into place, so a reader never sees half a file.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.training import adam_state, adam_update
from repro_torch.data.video import make_dataset
from repro_torch.vision import dnn as V
from repro_torch.weights import final_dnn_from_numpy, final_dnn_to_numpy

CACHE = Path(__file__).resolve().parents[3] / "experiments" / "models_torch"
LR, WARMUP, BATCH = 2e-3, 50, 4


def _save(net: V.FinalDNN, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **final_dnn_to_numpy(net))
    os.replace(tmp, path)


def train_final_dnn(task: str, genre: str, steps: int = 400, seed: int = 0,
                    H: int = 384, W: int = 640, width: int = 32,
                    cache: bool = True, name: str | None = None,
                    device="cuda") -> V.FinalDNN:
    """``steps`` Adam steps (lr 2e-3, 50 steps of warm-up) on batches of 4
    frames drawn with ``np.random.default_rng(seed)`` from 6 scenes of 8
    frames; with ``cache``, loaded from (or saved to) ``CACHE/name.npz``."""
    name = name or f"{task}_{genre}_w{width}_s{steps}"
    path = CACHE / f"{name}.npz"
    if cache and path.exists():
        with np.load(path) as npz:
            return final_dnn_from_numpy(task, dict(npz), device=device,
                                        name=name)

    net = V.init_net(task, seed, width, device)
    dev = net.device
    scenes = make_dataset(genre, n_scenes=6, frames_per_scene=8,
                          seed=seed, H=H, W=W)
    frames = torch.from_numpy(
        np.concatenate([s.frames for s in scenes])).to(dev)  # (N, H, W, 3)
    if task == "detection":
        targets = V.render_detection_targets(
            [b for s in scenes for b in s.boxes], H, W, dev)
        loss_fn = lambda idx: V.detection_train_loss(  # noqa: E731
            net, frames[idx], tuple(t[idx] for t in targets))
    elif task == "segmentation":
        masks = np.concatenate([s.masks for s in scenes])
        seg_t = torch.from_numpy(
            masks[:, ::V.STRIDE, ::V.STRIDE].astype(np.int64)).to(dev)
        loss_fn = lambda idx: V.segmentation_train_loss(  # noqa: E731
            net, frames[idx], seg_t[idx])
    else:
        kp_t = V.render_kp_targets(
            [k for s in scenes for k in s.keypoints], H, W, device=dev)
        loss_fn = lambda idx: V.keypoint_train_loss(  # noqa: E731
            net, frames[idx], kp_t[idx])

    params = list(net.parameters())
    m, v = adam_state(params)
    rng = np.random.default_rng(seed)
    n = frames.shape[0]
    for t in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, BATCH), device=dev)
        # the detector's "off" head has no loss: zero gradients, as the
        # reference's, leave it where it was drawn
        grads = torch.autograd.grad(loss_fn(idx), params, allow_unused=True,
                                    materialize_grads=True)
        adam_update(params, grads, m, v, t, LR, WARMUP)
    net.name = name
    if cache:
        _save(net, path)
    return net
