"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py      # from the repository root, on a CUDA host

1. Prints the card's name and power limit, and builds the CUDA kernels
   from ``src/repro_torch/kernels`` with nvcc into ``build/kernels/``.
2. Kernel phase: each kernel (``mbcodec_frame``, ``mbcodec_chunk`` with
   and without the reference clip) runs at the main path's shapes
   (T=10 frames, N=2880 blocks) against its plain PyTorch version on the
   same inputs; it must agree (see ``check_kernel``) and both are timed
   with CUDA events.
3. Main path: the single-stream AccMPEG loop,
   ``StreamingEngine.run(AccMPEGPolicy)``, at full size (dashcam scene,
   30 frames of 384x640, detection FinalDNN width 32, AccModel width 16,
   weights drawn from a seeded ``torch.Generator``) under the codec
   backends exact, pallas, fused and fused_exact. Each run's kernel
   launches are counted, every op is checked to run on the card, and the
   kernel backends' bytes are held against exact's.
4. Prints one JSON line with each kernel's launches, error and times, the
   line ``kernels: ...``, and last ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; nothing is caught. Without CUDA,
or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 without tensor cores, same sheet
# per coefficient and frame beyond the transforms' 4 x 16 multiply-adds:
# residual, step (qstep * w), divide, round, abs, 1 + |q|, log2, the bit
# cost's multiply-add (2), nonzero test, bit sum, dequantize, add to the
# reference
ELEMENTWISE_FLOP = 13
CHUNK_FRAMES, SCENE_FRAMES, HEIGHT, WIDTH_PX = 10, 30, 384, 640
KERNEL_SOURCE = "src/repro_torch/kernels/mbcodec/csrc/mbcodec.cu"
REPLACES = {"mbcodec_frame": "src/repro/kernels/mbcodec/kernel.py:208",
            "mbcodec_chunk": "src/repro/kernels/mbcodec/kernel.py:133"}
BACKENDS = ("exact", "pallas", "fused", "fused_exact")
# an array on the host may appear only where data crosses to or from the
# card: the copy itself, numpy input wrapped before its copy (lift_fresh)
# and the detach that .numpy() does on the host copy. 0-dim host tensors
# are wrapped Python scalars, which PyTorch passes along with CUDA
# operands.
TRANSFER_OPS = {"aten._to_copy.default", "aten.copy_.default",
                "aten.lift_fresh.default", "aten.detach.default"}


def log(*args):
    print(*args, flush=True)


def _event_median(run, iters):
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        run()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_ms(fn, iters=20, reps=10):
    """(device ms, eager ms) per call of ``fn``. Device: ``reps`` calls
    captured in one CUDA graph, replayed ``iters`` times between CUDA
    events, median / reps; the replay launches no Python, so this is the
    card's time for the work. Eager: the median of ``iters`` event-timed
    calls, host wrapper included, as the engine calls it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    device = _event_median(graph.replay, iters) / reps
    return device, _event_median(fn, iters)


def bound_ms(T, N):
    """Least time for one call on T frames of N blocks: each input read
    once and each output written once at the memory rate, or the fp32
    operations at the CUDA-core rate, whichever is larger."""
    coefs = T * N * 256
    # blocks and rec, qp and bits, D and w; 4 bytes each
    moved = 4 * (2 * coefs + 2 * T * N + 2 * 256)
    flop = T * N * 4 * 2 * 16 ** 3 + coefs * ELEMENTWISE_FLOP
    t_bytes, t_ops = moved / H100_BYTES_PER_S, flop / H100_FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, got, want):
    """got/want = (rec, bits, q) with a leading frame axis. Fails unless
    flipped coefficients are at most 1e-4 of all, and blocks that never
    flip agree: decoded max abs <= 1e-5, bits rtol <= 1e-3. Per-frame bit
    totals, flips included, agree within rtol 1e-3."""
    flips = got[2] != want[2]
    n_flips = int(flips.sum())
    clean = ~flips.flatten(2).any(-1).any(0)  # (N,) blocks never flipped
    err = (got[0] - want[0]).abs()
    clean_err = float(err[:, clean].max())
    bits_rel = float(((got[1] - want[1]).abs()
                      / want[1].abs())[:, clean].max())
    frame_rel = float(((got[1].sum(1) - want[1].sum(1)).abs()
                       / want[1].sum(1)).max())
    log(f"  {name}: decoded max abs {float(err.max()):.3e} "
        f"(blocks without flips {clean_err:.3e}), flipped coefficients "
        f"{n_flips} of {flips.numel()} in {int((~clean).sum())} blocks, "
        f"bits max rel {bits_rel:.3e} (frame totals {frame_rel:.3e})")
    if n_flips > 1e-4 * flips.numel():
        raise AssertionError(f"{name}: {n_flips} round-half flips")
    if clean_err > 1e-5 or bits_rel > 1e-3 or frame_rel > 1e-3:
        raise AssertionError(f"{name}: disagrees with its plain version")
    return float(err.max())


def kernel_phase(frames):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.mbcodec import kernel as K
    from repro_torch.kernels.mbcodec.ops import _chunk_blocks
    from repro_torch.kernels.mbcodec.ref import (mbcodec_chunk_ref,
                                                 mbcodec_ref)

    blocks, n_mb, C = _chunk_blocks(frames)
    T, N = blocks.shape[:2]
    rng = np.random.default_rng(0)  # two-level map, one per chunk
    qmap = np.where(rng.random(n_mb) < 0.4, 30.0, 40.0).astype(np.float32)
    qp = torch.from_numpy(np.repeat(qmap, C)).cuda().expand(T, N).contiguous()
    log(f"kernel phase: T={T}, N={N} blocks ({n_mb} macroblocks x {C})")

    variants = {
        "mbcodec_frame": (
            lambda q=False: K.mbcodec_frame_cuda(blocks[0], qp[0], want_q=q),
            lambda q=False: mbcodec_ref(blocks[0], qp[0], want_q=q), 1)}
    for clip in (False, True):
        variants[K.chunk_kernel_name(clip)] = (
            lambda q=False, c=clip: K.mbcodec_chunk_cuda(blocks, qp, c,
                                                         want_q=q),
            lambda q=False, c=clip: mbcodec_chunk_ref(blocks, qp, c,
                                                      want_q=q), T)
    rows = {}
    for name, (kern, plain, frames_in) in variants.items():
        got, want = kern(True), plain(True)
        torch.cuda.synchronize()
        if frames_in == 1:
            got, want = ([t[None] for t in x] for x in (got, want))
        max_err = check_kernel(name, got, want)
        (ms, eager), (plain_ms, plain_eager) = time_ms(kern), time_ms(plain)
        b_ms, b_by = bound_ms(frames_in, N)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); called eagerly: kernel "
            f"{eager:.4f} ms, plain {plain_eager:.4f} ms")
        rows[name] = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                      "replaces": REPLACES[name.split("[")[0]],
                      "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return rows


class DeviceAudit(TorchDispatchMode):
    """Records every op, other than a transfer between host and card, that
    touches an array (a tensor of one or more dimensions) off the card."""

    def __init__(self):
        super().__init__()
        self.off_card = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = [t for t in torch.utils._pytree.tree_leaves(
            (args, kwargs, out)) if isinstance(t, torch.Tensor) and t.dim()]
        if str(func) not in TRANSFER_OPS and any(
                t.device.type != "cuda" for t in tensors):
            self.off_card.add(str(func))
        return out


def main_path_phase(scene_frames, rows):
    from repro_torch.core.accmodel import AccModel
    from repro_torch.core.pipeline import make_reference
    from repro_torch.core.quality import QualityConfig, dilate_scores
    from repro_torch.engine import AccMPEGPolicy, StreamingEngine
    from repro_torch.kernels.mbcodec.kernel import LAUNCHES, chunk_kernel_name
    from repro_torch.vision.dnn import FinalDNN

    g = torch.Generator().manual_seed(0)
    dnn = FinalDNN("detection", width=32, generator=g, device="cuda")
    am = AccModel(width=16, generator=g, device="cuda")
    refs = make_reference(scene_frames, dnn, qp_hi=30)
    # untrained scores are nearly uniform, and dilation would spread any
    # raw-score threshold over almost every block; since dilate(s >= a) is
    # dilate_scores(s) >= a, the median of chunk 0's dilated scores as
    # alpha puts about half the blocks at each QP level
    alpha = float(dilate_scores(am.scores(scene_frames[:1]), 2).median())
    qcfg = QualityConfig(alpha=alpha, gamma=2)
    log(f"main path: {scene_frames.shape[0]} frames of "
        f"{scene_frames.shape[1]}x{scene_frames.shape[2]}, detection "
        f"FinalDNN width 32, AccModel width 16, alpha {alpha:.6f}, gamma 2")

    uses = {"exact": None, "pallas": "mbcodec_frame",
            "fused": chunk_kernel_name(False),
            "fused_exact": chunk_kernel_name(True)}
    LAUNCHES.clear()  # every count to 0 just before the main path
    results, off_card = {}, set()
    for impl in BACKENDS:
        before = dict(LAUNCHES)
        audit = DeviceAudit()
        with audit:
            results[impl] = StreamingEngine(dnn, impl=impl).run(
                AccMPEGPolicy(am, qcfg), scene_frames, refs=refs)
        torch.cuda.synchronize()
        moved = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                 if v != before.get(k, 0)}
        log(f"  {impl}: launches {moved}")
        off_card |= audit.off_card
        expect = uses[impl]
        if set(moved) != ({expect} if expect else set()):
            raise AssertionError(f"{impl} launched {moved}, expected "
                                 f"only {expect}")
    launches = dict(LAUNCHES)  # read just after the main path
    if off_card:
        raise AssertionError(f"ops off the card: {sorted(off_card)}")
    log("  every op of the four runs ran on cuda (transfers aside)")

    exact = results["exact"]
    for impl in BACKENDS:
        r = results[impl]
        acc = [c.accuracy for c in r.chunks]
        nbytes = [c.bytes for c in r.chunks]
        if len(r.chunks) != SCENE_FRAMES // CHUNK_FRAMES or not all(
                np.isfinite(acc + nbytes)) or not all(
                0.0 <= a <= 1.0 for a in acc) or min(nbytes) <= 0:
            raise AssertionError(f"{impl}: malformed result {acc} {nbytes}")
        if impl in ("pallas", "fused_exact"):  # exact's semantics
            rel = max(abs(a.bytes - b.bytes) / b.bytes
                      for a, b in zip(r.chunks, exact.chunks))
            log(f"  {impl}: per-chunk bytes within {rel:.3e} of exact")
            if rel > 1e-3:
                raise AssertionError(f"{impl} bytes differ from exact")

    # a second run of each backend outside the audit gives the timings
    for impl in BACKENDS:
        policy = AccMPEGPolicy(am, qcfg)
        summary = StreamingEngine(dnn, impl=impl).run(
            policy, scene_frames, refs=refs).summary()
        hi = float(torch.cat(policy.masks).float().mean())
        log(f"  {impl} summary: {json.dumps(summary)} high-QP share "
            f"{hi:.4f}")
    for name, row in rows.items():
        row["launches"] = launches.get(name, 0)
        if row["launches"] < 1:
            raise AssertionError(f"{name} never launched on the main path")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.video import make_scene
    from repro_torch.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN, "
        f"float32 matmul precision 'highest'")

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, (secs, report) in built.items():
        log(f"  nvcc {name}: {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    t0 = time.perf_counter()
    scene = make_scene("dashcam", seed=33, T=SCENE_FRAMES, H=HEIGHT,
                       W=WIDTH_PX)
    frames = torch.from_numpy(scene.frames).cuda()
    log(f"scene: {time.perf_counter() - t0:.2f} s")

    rows = kernel_phase(frames[:CHUNK_FRAMES])
    main_path_phase(frames, rows)
    log(json.dumps({"kernels": list(rows.values())}))
    log("kernels: mbcodec_frame, mbcodec_chunk")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
