"""Deterministic synthetic video scenes (driving / dashcam / surf genres).

A copy of ``repro.data.video`` (numpy only, same seeds and random streams),
so that the port needs nothing of ``repro``.

The paper evaluates on YouTube videos (offline here); these scenes model
the genre statistics that matter for the technique: small moving objects
over textured backgrounds (driving/dashcam) and a single articulated
subject (surf). Ground-truth boxes / masks / keypoints come with every
frame, and the *final-DNN-relative* accuracy metric (vs D(H), per the
paper §2 fn.3) transfers unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

GENRES = ("driving", "dashcam", "surf")


@dataclasses.dataclass
class Scene:
    frames: np.ndarray   # (T, H, W, 3) float32 [0,1]
    boxes: list          # per-frame list of (x0, y0, x1, y1)
    masks: np.ndarray    # (T, H, W) uint8 {0,1}
    keypoints: list      # per-frame list of (K, 2) arrays (x, y)
    genre: str


def _background(rng, T, H, W, pan_speed=1.0):
    """Textured background with slow camera pan."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.zeros((H, W), np.float32)
    for _ in range(6):
        fx, fy = rng.uniform(0.002, 0.02, 2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.05, 0.15)
        base += amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
    base = 0.45 + base
    noise = rng.normal(0, 0.015, (H, W)).astype(np.float32)
    frames = np.zeros((T, H, W, 3), np.float32)
    tint = rng.uniform(0.85, 1.15, 3).astype(np.float32)
    for t in range(T):
        shift = int(t * pan_speed)
        b = np.roll(base + noise, shift, axis=1)
        frames[t] = b[..., None] * tint
    return np.clip(frames, 0.0, 1.0)


def _draw_rect(img, x0, y0, x1, y1, color, rng):
    H, W, _ = img.shape
    x0, x1 = int(max(0, x0)), int(min(W, x1))
    y0, y1 = int(max(0, y0)), int(min(H, y1))
    if x1 <= x0 + 1 or y1 <= y0 + 1:
        return False
    h, w = y1 - y0, x1 - x0
    gy = np.linspace(0.85, 1.15, h)[:, None, None]
    img[y0:y1, x0:x1] = np.clip(np.asarray(color)[None, None] * gy, 0, 1)
    # border + a window-like inner patch so objects have edges/detail
    img[y0:y1, x0:x0 + max(1, w // 12)] *= 0.4
    img[y0:y0 + max(1, h // 10), x0:x1] *= 0.4
    iy0, ix0 = y0 + h // 4, x0 + w // 4
    img[iy0:iy0 + max(1, h // 5), ix0:ix0 + max(1, w // 3)] = 0.15
    return True


def _stable_hash(s: str) -> int:
    h = 0
    for ch in s:  # NOT hash(): that is randomized per process
        h = (h * 131 + ord(ch)) % 7919
    return h


def make_scene(genre: str, seed: int = 0, T: int = 30, H: int = 384,
               W: int = 640) -> Scene:
    rng = np.random.default_rng(seed * 1001 + _stable_hash(genre))
    if genre == "driving":
        n_obj, pan, approach = rng.integers(4, 9), 0.6, True
    elif genre == "dashcam":
        n_obj, pan, approach = rng.integers(3, 7), 1.4, True
    elif genre == "surf":
        n_obj, pan, approach = 1, 0.3, False
    else:
        raise ValueError(genre)

    frames = _background(rng, T, H, W, pan)
    boxes: List[list] = [[] for _ in range(T)]
    masks = np.zeros((T, H, W), np.uint8)
    keypoints: List[list] = [[] for _ in range(T)]

    objs = []
    for oi in range(int(n_obj)):
        # a minority of small, low-contrast objects — the regime where
        # encoding quality decides detectability (paper §7 notes tiny
        # objects are also where the cheap AccModel itself struggles, so
        # the mix keeps them a minority, like ordinary dashcam footage)
        small = oi % 3 == 0 and genre != "surf"
        w0 = rng.uniform(12, 26) if small else rng.uniform(24, 64)
        contrast = rng.uniform(0.3, 0.5) if small else rng.uniform(0.35, 0.8)
        base = rng.uniform(0.35, 0.6)
        color = np.clip(base + contrast * rng.uniform(-1, 1, 3), 0.05, 0.95)
        objs.append({
            "cx": rng.uniform(0.1 * W, 0.9 * W),
            "cy": rng.uniform(0.35 * H, 0.85 * H),
            "w": w0, "h": w0 * rng.uniform(0.55, 0.8),
            "vx": rng.uniform(-3.5, 3.5), "vy": rng.uniform(-1.0, 1.0),
            "grow": rng.uniform(1.0, 1.02) if approach else 1.0,
            "color": color,
        })

    for t in range(T):
        img = frames[t]
        for o in objs:
            cx = o["cx"] + o["vx"] * t
            cy = o["cy"] + o["vy"] * t
            s = o["grow"] ** t
            w, h = o["w"] * s, o["h"] * s
            x0, y0, x1, y1 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
            if _draw_rect(img, x0, y0, x1, y1, o["color"], rng):
                bx = (max(0, x0), max(0, y0), min(W, x1), min(H, y1))
                boxes[t].append(bx)
                masks[t, int(bx[1]):int(bx[3]), int(bx[0]):int(bx[2])] = 1
                if genre == "surf":
                    # articulated subject: 5 keypoints (head, 2 hands, 2 feet)
                    kps = np.array([
                        [cx, y0 + 0.1 * h],
                        [x0 + 0.1 * w, cy], [x1 - 0.1 * w, cy],
                        [x0 + 0.25 * w, y1 - 0.08 * h],
                        [x1 - 0.25 * w, y1 - 0.08 * h],
                    ], np.float32)
                    keypoints[t].append(kps)
    return Scene(frames, boxes, masks, keypoints, genre)


def make_dataset(genre: str, n_scenes: int, frames_per_scene: int = 30,
                 seed: int = 0, H: int = 384, W: int = 640):
    return [make_scene(genre, seed=seed + i, T=frames_per_scene, H=H, W=W)
            for i in range(n_scenes)]
