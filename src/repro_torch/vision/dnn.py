"""Server-side final DNNs (port of ``repro.vision.dnn``): the detector,
segmenter and keypoint net, treated as black boxes by the AccMPEG core.

Public functions keep the reference's layouts: frames in NHWC, outputs as
dicts of NHWC maps at stride 8. Inside, convolutions run in NCHW with
TensorFlow-style SAME padding written out, because PyTorch's symmetric
``padding=1`` is one pixel off for stride-2 convolutions on even inputs
(XLA pads (0, 1) there). Accuracy is scored on the host in numpy against
D(H), the DNN's output on the high-quality frames, as in the reference;
the scorers take tensors or numpy arrays, and the ``_batched`` ones score
every lane of a fleet's (N, T, ...) outputs in one pass. The target
renderers and training losses train D itself (``vision/train.py``);
``FinalDNN.proxy_loss`` is the differentiable accuracy proxy AccGrad
differentiates.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device

STRIDE = 8  # output stride of every head
TASK_HEADS = {"detection": {"heat": 1, "wh": 2, "off": 2},
              "segmentation": {"seg": 2}, "keypoint": {"kp": 5}}


# ---------------------------------------------------------------------------
# conv substrate
# ---------------------------------------------------------------------------
def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's ``padding="SAME"`` does: the total
    ``max((ceil(n/s) - 1) * s + k - n, 0)`` split low = total // 2."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: last dim first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class Conv(nn.Module):
    """k x k convolution with SAME padding. The reference's HWIO weight
    ``(k, k, ci/groups, co)`` is stored as OIHW ``(co, ci/groups, k, k)``;
    initialised like ``repro.vision.dnn.conv_init``: N(0, 1/fan_in), zero
    bias."""

    def __init__(self, k: int, ci: int, co: int, stride: int = 1,
                 groups: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        fan_in = k * k * (ci // groups)
        self.weight = nn.Parameter(
            torch.randn((co, ci // groups, k, k), generator=generator)
            / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(co))

    def forward(self, x):
        return F.conv2d(same_pad(x, self.k, self.stride), self.weight,
                        self.bias, self.stride, groups=self.groups)


class DwSep(nn.Module):
    """Depthwise 3x3 (groups=ci) + ReLU, pointwise 1x1 + ReLU."""

    def __init__(self, ci: int, co: int, stride: int = 1, generator=None):
        super().__init__()
        self.dw = Conv(3, ci, ci, stride, groups=ci, generator=generator)
        self.pw = Conv(1, ci, co, generator=generator)

    def forward(self, x):
        return F.relu(self.pw(F.relu(self.dw(x))))


class Backbone(nn.Module):
    """(B, 3, H, W) -> (B, 3*width, H/8, W/8)."""

    def __init__(self, width: int = 32, generator=None):
        super().__init__()
        g, w = generator, width
        self.stem = Conv(3, 3, w // 2, stride=2, generator=g)
        self.b1 = DwSep(w // 2, w, 2, g)
        self.b2 = DwSep(w, w * 2, 2, g)
        self.b3 = DwSep(w * 2, w * 3, 1, g)
        self.b4 = DwSep(w * 3, w * 3, 1, g)

    def forward(self, x):
        x = F.relu(self.stem(x))
        return self.b4(self.b3(self.b2(self.b1(x))))


class Head(nn.Module):
    def __init__(self, ci: int, cout: int, generator=None):
        super().__init__()
        self.c1 = Conv(3, ci, 64, generator=generator)
        self.c2 = Conv(1, 64, cout, generator=generator)

    def forward(self, x):
        return self.c2(F.relu(self.c1(x)))


def to_nchw(frames: torch.Tensor) -> torch.Tensor:
    return frames.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# ground-truth target rendering and training losses (to train D itself on
# synthetic scenes); targets are rendered in numpy on the host
# ---------------------------------------------------------------------------
def render_detection_targets(boxes_per_frame, H, W, device="cuda"):
    """-> (heat (B, hs, ws, 1), wh (B, hs, ws, 2), mask (B, hs, ws, 1))
    float32 tensors on ``device``: a Gaussian per box at its centre, its
    size in head units and a 1 at its centre cell."""
    hs, ws = H // STRIDE, W // STRIDE
    B = len(boxes_per_frame)
    heat = np.zeros((B, hs, ws, 1), np.float32)
    wh = np.zeros((B, hs, ws, 2), np.float32)
    mask = np.zeros((B, hs, ws, 1), np.float32)
    yy, xx = np.mgrid[0:hs, 0:ws]
    for b, boxes in enumerate(boxes_per_frame):
        for (x0, y0, x1, y1) in boxes:
            cx, cy = (x0 + x1) / 2 / STRIDE, (y0 + y1) / 2 / STRIDE
            w, h = (x1 - x0) / STRIDE, (y1 - y0) / STRIDE
            if w < 0.5 or h < 0.5:
                continue
            sig = max(0.8, 0.15 * np.sqrt(w * h))
            g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
            heat[b, :, :, 0] = np.maximum(heat[b, :, :, 0], g)
            ci, cj = int(np.clip(cy, 0, hs - 1)), int(np.clip(cx, 0, ws - 1))
            wh[b, ci, cj] = (w, h)
            mask[b, ci, cj] = 1.0
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (heat, wh, mask))


def render_kp_targets(kps_per_frame, H, W, K=5, device="cuda"):
    """-> keypoint heat (B, hs, ws, K) float32 on ``device``."""
    hs, ws = H // STRIDE, W // STRIDE
    B = len(kps_per_frame)
    heat = np.zeros((B, hs, ws, K), np.float32)
    yy, xx = np.mgrid[0:hs, 0:ws]
    for b, persons in enumerate(kps_per_frame):
        for kps in persons:
            for k in range(min(K, len(kps))):
                cx, cy = kps[k][0] / STRIDE, kps[k][1] / STRIDE
                g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 1.5 ** 2))
                heat[b, :, :, k] = np.maximum(heat[b, :, :, k], g)
    return torch.from_numpy(heat).to(resolve_device(device))


def detection_train_loss(net, frames, targets):
    """Penalty-reduced focal loss on the heat (CenterNet) plus 0.1 x the L1
    size loss at object centres; ``targets`` from
    :func:`render_detection_targets`."""
    out = net(frames)
    heat_t, wh_t, mask = targets
    p = torch.sigmoid(out["heat"])
    pos = (heat_t > 0.95).to(torch.float32)
    lp = -pos * ((1 - p) ** 2) * torch.log(p + 1e-6)
    ln = -(1 - pos) * ((1 - heat_t) ** 4) * (p ** 2) * torch.log(1 - p + 1e-6)
    n_pos = pos.sum().clamp_min(1.0)
    l_heat = (lp + ln).sum() / n_pos
    l_wh = ((out["wh"] - wh_t).abs() * mask).sum() / mask.sum().clamp_min(1.0)
    return l_heat + 0.1 * l_wh


def segmentation_train_loss(net, frames, seg_t):
    """Two-class cross-entropy against integer labels (B, hs, ws)."""
    logp = F.log_softmax(net(frames)["seg"], dim=-1)
    onehot = F.one_hot(seg_t.long(), 2).to(logp.dtype)
    return -(onehot * logp).mean() * 2.0


def keypoint_train_loss(net, frames, kp_heat_t):
    out = net(frames)["kp"]
    return torch.mean((torch.sigmoid(out) - kp_heat_t) ** 2) * 100.0


# ---------------------------------------------------------------------------
# decoding + accuracy metrics (host-side, vs D(H))
# ---------------------------------------------------------------------------
def _np(x) -> np.ndarray:
    """A host numpy array of ``x`` (a tensor anywhere, or an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sigmoid_np(x) -> np.ndarray:
    """Sigmoid on the host, through PyTorch's kernel whichever form ``x``
    has, so per-lane and batched scoring round alike."""
    return _np(torch.sigmoid(torch.as_tensor(x)))


def detection_keep_heat(out) -> torch.Tensor:
    """Sigmoid + 3x3 max-pool NMS with the reference's 1e-6 slack ->
    suppressed heat (B, hs, ws)."""
    heat = torch.sigmoid(out["heat"][..., 0])
    pooled = F.max_pool2d(heat[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(heat >= pooled - 1e-6, heat, 0.0)


def decode_detections(out, thresh=0.3, topk=50):
    """-> per-frame list of (x0, y0, x1, y1, score)."""
    keep = out["keep"] if "keep" in out else detection_keep_heat(
        {"heat": torch.as_tensor(out["heat"])})
    keep_np = _np(keep)
    wh = _np(out["wh"])
    results = []
    for b in range(keep_np.shape[0]):
        ys, xs = np.where(keep_np[b] >= thresh)
        scores = keep_np[b][ys, xs]
        order = np.argsort(-scores)[:topk]
        dets = []
        for i in order:
            y, x = ys[i], xs[i]
            w, h = np.maximum(wh[b, y, x], 0.5)
            cx, cy = (x + 0.5) * STRIDE, (y + 0.5) * STRIDE
            dets.append((cx - w * STRIDE / 2, cy - h * STRIDE / 2,
                         cx + w * STRIDE / 2, cy + h * STRIDE / 2,
                         float(scores[i])))
        results.append(dets)
    return results


def _iou(a, b):
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def detection_f1(dets, refs, iou_thresh=0.5):
    """Mean F1 across frames, greedy IoU matching vs D(H) detections."""
    f1s = []
    for d, r in zip(dets, refs):
        if not r and not d:
            f1s.append(1.0)
            continue
        matched = set()
        tp = 0
        for box in sorted(d, key=lambda x: -x[4]):
            best, bi = 0.0, -1
            for j, rb in enumerate(r):
                if j in matched:
                    continue
                i = _iou(box, rb)
                if i > best:
                    best, bi = i, j
            if best >= iou_thresh:
                matched.add(bi)
                tp += 1
        prec = tp / max(len(d), 1)
        rec = tp / max(len(r), 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-9))
    return float(np.mean(f1s)) if f1s else 1.0


def segmentation_iou(out, ref_out):
    a = _np(out["seg"]).argmax(-1)
    b = _np(ref_out["seg"]).argmax(-1)
    ious = []
    for cls in (0, 1):
        inter = np.logical_and(a == cls, b == cls).sum()
        union = np.logical_or(a == cls, b == cls).sum()
        if union > 0:
            ious.append(inter / union)
    return float(np.mean(ious)) if ious else 1.0


def keypoint_accuracy(out, ref_out, radius=2.0):
    """Fraction of keypoints within ``radius`` head-units of the reference
    prediction."""
    def peaks(o):
        h = _sigmoid_np(o["kp"])
        B, hs, ws, K = h.shape
        flat = h.reshape(B, hs * ws, K).argmax(axis=1)
        return np.stack([flat // ws, flat % ws], axis=-1)  # (B, K, 2)

    pa, pb = peaks(out), peaks(ref_out)
    d = np.sqrt(((pa - pb) ** 2).sum(-1))
    return float((d <= radius).mean())


# ---------------------------------------------------------------------------
# batched (per-lane) accuracy: the fleet's vectorized host scoring
# ---------------------------------------------------------------------------
# The fleet's server step returns one output tree whose leaves carry a
# leading lane axis, (N, T, hs, ws, C), fetched to the host once per chunk.
# These score every lane in one numpy pass and match ``FinalDNN.accuracy``
# on each lane's slice bit for bit (same reductions in the same order).

def _decode_detection_frames(keep_np, wh, thresh=0.3, topk=50):
    """Decode a flat (F, hs, ws) stack of suppressed heatmaps into F
    per-frame detection lists. One global ``np.where`` grouped by frame
    with ``searchsorted`` replaces F per-frame calls; its row-major order
    gives each frame the candidate order, argsort ties and boxes of
    :func:`decode_detections` on that frame alone."""
    fs, ys_all, xs_all = np.where(keep_np >= thresh)
    bounds = np.searchsorted(fs, np.arange(keep_np.shape[0] + 1))
    results = []
    for b in range(keep_np.shape[0]):
        lo, hi = bounds[b], bounds[b + 1]
        ys, xs = ys_all[lo:hi], xs_all[lo:hi]
        scores = keep_np[b][ys, xs]
        order = np.argsort(-scores)[:topk]
        dets = []
        for i in order:
            y, x = ys[i], xs[i]
            w, h = np.maximum(wh[b, y, x], 0.5)
            cx, cy = (x + 0.5) * STRIDE, (y + 0.5) * STRIDE
            dets.append((cx - w * STRIDE / 2, cy - h * STRIDE / 2,
                         cx + w * STRIDE / 2, cy + h * STRIDE / 2,
                         float(scores[i])))
        results.append(dets)
    return results


def _lane_keep(out):
    """Suppressed detection heat of a (N, T, ...) lane tree as (N*T, hs,
    ws): the server step's ``"keep"`` where it has one, else the NMS run
    over the lanes folded into the batch axis."""
    if "keep" in out:
        keep = _np(out["keep"])
        return keep.reshape((-1,) + keep.shape[2:])
    heat = torch.as_tensor(out["heat"])
    flat = {"heat": heat.reshape((-1,) + tuple(heat.shape[2:]))}
    return _np(detection_keep_heat(flat))


def detection_f1_batched(out, ref_out, iou_thresh=0.5):
    """Per-lane mean F1 for lane trees with leaves (N, T, ...) -> (N,)
    float64, entry i bit-equal to ``detection_f1`` on lane i."""
    keep = _lane_keep(out)
    wh = _np(out["wh"])
    n, t = wh.shape[:2]
    wh = wh.reshape((n * t,) + wh.shape[2:])
    ref_keep = _lane_keep(ref_out)
    ref_wh = _np(ref_out["wh"])
    ref_wh = ref_wh.reshape((n * t,) + ref_wh.shape[2:])
    dets = _decode_detection_frames(keep, wh)
    refs = _decode_detection_frames(ref_keep, ref_wh)
    return np.asarray([
        detection_f1(dets[b * t:(b + 1) * t], refs[b * t:(b + 1) * t],
                     iou_thresh)
        for b in range(n)], np.float64)


def segmentation_iou_batched(out, ref_out):
    """Per-lane segmentation IoU for (N, T, hs, ws, C) trees -> (N,)."""
    a = _np(out["seg"]).argmax(-1)      # (N, T, hs, ws)
    b = _np(ref_out["seg"]).argmax(-1)
    axes = tuple(range(1, a.ndim))
    lanes = []
    for cls in (0, 1):
        inter = np.logical_and(a == cls, b == cls).sum(axis=axes)
        union = np.logical_or(a == cls, b == cls).sum(axis=axes)
        lanes.append((inter, union))
    out_acc = np.empty(a.shape[0], np.float64)
    for i in range(a.shape[0]):
        # the per-lane path's short list and np.mean: the same (at most
        # two-term) summation order
        ious = [inter[i] / union[i] for inter, union in lanes
                if union[i] > 0]
        out_acc[i] = float(np.mean(ious)) if ious else 1.0
    return out_acc


def keypoint_accuracy_batched(out, ref_out, radius=2.0):
    """Per-lane keypoint accuracy for (N, T, hs, ws, K) trees -> (N,)."""
    def peaks(o):
        h = _sigmoid_np(o["kp"])
        n, t, hs, ws, k = h.shape
        flat = h.reshape(n, t, hs * ws, k).argmax(axis=2)
        return np.stack([flat // ws, flat % ws], axis=-1)  # (N, T, K, 2)

    pa, pb = peaks(out), peaks(ref_out)
    d = np.sqrt(((pa - pb) ** 2).sum(-1))
    return (d <= radius).mean(axis=(1, 2)).astype(np.float64)


def device_lane_accuracy(task, out, ref_out) -> torch.Tensor:
    """Per-lane accuracy (N,) float32 for (N, T, ...) lane trees of
    tensors, computed where the outputs lie, so that the fleet reduces
    accuracy on the card and only N scalars cross to the host.

    Only segmentation (IoU pooled over the lane's frames, per class) and
    keypoint (PCK at radius 2 in output cells) reduce here; detection's
    greedy F1 matching is data-dependent and stays on the (batched numpy)
    host path. The math is float32, so results track the float64 host
    path to ~1e-6 rather than bit for bit."""
    if task == "segmentation":
        a = torch.argmax(out["seg"], -1)
        b = torch.argmax(ref_out["seg"], -1)
        axes = tuple(range(1, a.dim()))
        iou_sum = torch.zeros(a.shape[0], dtype=torch.float32,
                              device=a.device)
        n_valid = torch.zeros_like(iou_sum)
        for cls in (0, 1):
            inter = ((a == cls) & (b == cls)).sum(dim=axes)
            union = ((a == cls) | (b == cls)).sum(dim=axes)
            valid = union > 0
            iou = torch.where(valid, inter.to(torch.float32)
                              / union.clamp_min(1).to(torch.float32), 0.0)
            iou_sum = iou_sum + iou
            n_valid = n_valid + valid.to(torch.float32)
        return torch.where(n_valid > 0, iou_sum / n_valid.clamp_min(1.0),
                           1.0)
    if task == "keypoint":
        def peaks(o):
            h = torch.sigmoid(o["kp"])
            n, t, hs, ws, k = h.shape
            flat = h.reshape(n, t, hs * ws, k).argmax(dim=2)
            return torch.stack([flat // ws, flat % ws], dim=-1)

        pa, pb = peaks(out), peaks(ref_out)
        d = torch.sqrt(((pa - pb) ** 2).sum(-1).to(torch.float32))
        return (d <= 2.0).to(torch.float32).mean(dim=(1, 2))
    raise ValueError(f"no device accuracy reduction for task {task!r} "
                     f"(detection decodes on host)")


# ---------------------------------------------------------------------------
# the black-box wrapper used by AccMPEG
# ---------------------------------------------------------------------------
class FinalDNN(nn.Module):
    """Task net: a backbone and one head per output, named as the
    reference's parameter tree (``backbone``, ``heat``/``wh``/``off``,
    ``seg`` or ``kp``). ``forward`` is the reference's ``apply_net``:
    frames (B, H, W, 3) -> dict of NHWC outputs at stride 8. Weights are
    drawn from ``generator`` (see ``repro_torch.weights`` to carry the
    reference's weights across instead)."""

    def __init__(self, task: str, width: int = 32,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", name: str = "final-dnn"):
        super().__init__()
        if task not in TASK_HEADS:
            raise ValueError(task)
        self.task, self.width, self.name = task, width, name
        self.device = resolve_device(device)
        self.backbone = Backbone(width, generator)
        for head, cout in TASK_HEADS[task].items():
            self.add_module(head, Head(width * 3, cout, generator))
        self.to(self.device)

    def forward(self, frames):
        f = self.backbone(to_nchw(frames))
        return {head: to_nhwc(getattr(self, head)(f))
                for head in TASK_HEADS[self.task]}

    @torch.no_grad()
    def predict(self, frames):
        return self(torch.as_tensor(frames, device=self.device))

    def proxy_loss(self, frames, ref_out):
        """Differentiable proxy of Acc(D(frames); D(H)) (the paper's fn.
        15): output consistency with ``ref_out`` = D(H), which is held
        constant."""
        out = self(frames)
        if self.task == "detection":
            ph = torch.sigmoid(ref_out["heat"].detach())
            p = torch.sigmoid(out["heat"])
            loss = torch.mean((p - ph) ** 2) * 100.0
            mask = (ph > 0.3).to(torch.float32)
            return loss + ((out["wh"] - ref_out["wh"].detach()).abs()
                           * mask).sum() / mask.sum().clamp_min(1.0) * 0.1
        if self.task == "segmentation":
            ref = torch.softmax(ref_out["seg"].detach(), dim=-1)
            logp = F.log_softmax(out["seg"], dim=-1)
            return -(ref * logp).mean() * 10.0
        ref = torch.sigmoid(ref_out["kp"].detach())
        return torch.mean((torch.sigmoid(out["kp"]) - ref) ** 2) * 100.0

    def accuracy(self, out, ref_out) -> float:
        if self.task == "detection":
            return detection_f1(decode_detections(out),
                                decode_detections(ref_out))
        if self.task == "segmentation":
            return segmentation_iou(out, ref_out)
        return keypoint_accuracy(out, ref_out)

    def accuracy_batched(self, out, ref_out) -> np.ndarray:
        """Score every lane of a (N, T, ...) output tree in one numpy pass
        -> (N,) float64, lane i bit-equal to ``accuracy`` on lane i."""
        if self.task == "detection":
            return detection_f1_batched(out, ref_out)
        if self.task == "segmentation":
            return segmentation_iou_batched(out, ref_out)
        return keypoint_accuracy_batched(out, ref_out)

    @property
    def supports_device_accuracy(self) -> bool:
        """Whether :func:`device_lane_accuracy` can reduce this task's
        accuracy on the device in windowed fleet serving (detection
        cannot: greedy box matching stays on the host)."""
        return self.task in ("segmentation", "keypoint")


def init_net(task: str, seed: int, width: int = 32,
             device="cuda") -> FinalDNN:
    """A fresh ``task`` net with weights drawn from a ``torch.Generator``
    seeded with ``seed`` (the trainer's initial weights)."""
    return FinalDNN(task, width, torch.Generator().manual_seed(seed),
                    device=device)
