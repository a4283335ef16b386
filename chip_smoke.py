"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py      # from the repository root, on a CUDA host

1. Prints the card's name and power limit, and builds the CUDA kernels
   from ``src/repro_torch/kernels`` with nvcc into ``build/kernels/``,
   logging ptxas's registers and spills; for each of the four
   ``mbcodec_chunk_kernel`` and eight ``wkv6`` instantiations also its
   shared memory (and stack frame), and it fails on a spill there (or a
   stack frame in the chunk kernel), or if the mbcodec library holds any
   kernel besides the four chunk kernel instantiations. It logs each of
   those four's SASS instruction count and top opcodes (``cuobjdump``).
2. Kernel phase: each mbcodec entry point (``mbcodec_frame``, the chunk
   kernel at T = 1; ``mbcodec_chunk`` with and without the reference
   clip; ``mbcodec_chunk_scores`` with and without it) runs at its path's
   shapes (one frame or T=10 frames of N=2880 blocks; 8 streams for the
   scores kernel) against its plain PyTorch version on the same inputs;
   it must agree (see ``check_kernel``) and both are timed with CUDA
   events. Each is also held to the same bounds against its row/column
   twin (``ref.py::mbcodec_chunk_rowcol``, the kernel's association) and
   logs its GB/s. The frame row is held bit for bit against
   ``mbcodec_chunk`` at T = 1, and the scores kernel against the
   explicit-array chunk kernel fed the QP map its threshold implies. The
   chunk kernel is also timed over 1, 2, 5 and 10 frames and on one
   thread block, to split a launch's fixed cost from a frame's (logged
   only).
3. Single-stream path: the AccMPEG loop,
   ``StreamingEngine.run(AccMPEGPolicy)``, at full size (dashcam scene,
   30 frames of 384x640, detection FinalDNN width 32, AccModel width 16,
   weights drawn from a seeded ``torch.Generator``) under the codec
   backends exact, pallas, fused and fused_exact. Each run's kernel
   launches are counted, every op is checked to run on the card, and the
   kernel backends' bytes are held against exact's. Then one
   ``torch.profiler`` window of one chunk's encode under pallas and under
   fused logs the launches and kernels, device against host ms, the busy
   share and the top ops (it checks nothing).
4. Fleet path: ``MultiStreamEngine.run`` over 8 dashcam streams of 30
   frames of 384x640 with the same models, under exact, fused and
   fused_exact overlapped and fused serialized, with the same launch and
   device checks; fused_exact's bytes are held against exact's, the
   fused fleet against 8 single-stream runs, and the overlapped against
   the serialized loop.
5. AccGrad kernel: ``accgrad_reduce`` at the label batch's shape (4
   frames of 384x640x3) against its plain version, relative error at most
   1e-5 of each macroblock's sum. Both are timed as above and, since the
   35 MB of inputs fit in the L2 cache, also with L2 flushed before each
   call; the flushed times go into the kernels line.
6. Training path at full size: 16 dashcam frames of 384x640 and the same
   detection FinalDNN. ``make_labels`` (batch 4) must make exactly 4
   ``accgrad_reduce`` launches with every op on the card, and its labels
   may differ from labels built from the same gradients through the plain
   reduction only where the normalised AccGrad lies within 1e-5 of the
   threshold. ``train_accmodel`` (15 epochs, width 16) must end below its
   first epoch's loss; ``train_accmodel_e2e`` runs the same, and both
   trainers' label and train times are printed (Table 2), after one
   untimed epoch of each on one batch has warmed the kernels. Last,
   ``train_final_dnn`` (detection, 400 steps, width 32, no cache) must
   lower the detection loss on a held batch.
7. LM kernels: ``decode_attn`` at the smollm decode path's shape (B=16,
   a 2048-token cache, KV=5, G=3, hd=64, pos=1087; bf16 and fp32) and at
   one smollm layer of the reference's decode_32k cell (B=128, S=32768,
   bf16) against its plain version (atol 1e-5, rtol 1e-4), with
   ``scaled_dot_product_attention`` on the same inputs timed as the
   library call; at the path's shape all three are timed with L2 flushed
   before each call (on the path each layer reads its own cache from
   device memory), the L2-hot times logged beside them, and each row logs
   its GB/s and share of the bound. Then one ``decode_attn`` call with
   ``pos`` in a device tensor is captured in a CUDA graph at the path's
   shape (bf16) and replayed at pos 0, 255, 256, 1087 and 2047: each
   output within the same bound of the plain version and bit for bit an
   eager call with the int. ``wkv6`` at the rwkv6 path's prefill (B=16,
   S=1024, H=32) and decode (S=1) shapes, r, k and v in bf16 (as the path
   passes them) and in fp32, against the reference model's chunked form,
   and on a ragged slice with log-decays down to -8 and s0 != 0 against
   the sequential oracle (atol 2e-4, rtol 1e-3, all finite); the bound of
   a row with S >= 2 takes its operations at the TF32 tensor-core rate
   over three (the kernel's products), of a decode row at the CUDA-core
   rate.
8. LM serving at full width, random bf16 weights from a seeded generator:
   smollm-360m and rwkv6-1.6b each prefill 16 prompts of 1024 tokens
   (``make_prefill_step`` with room for 2048) and take 64 greedy
   ``make_decode_step`` steps. The audited run must make exactly
   32 x 64 ``decode_attn`` launches in the decode steps, and 24 ``wkv6``
   launches in the prefill and 24 x 64 in the decode steps, with every
   op on the card and finite logits; a second run gives prefill tokens/s
   and decode ms per step, and ``torch.profiler`` the card's busy share
   of a prefill and of 8 decode steps. Then, in fp32, the decode logits
   after a 256-token prefill must match the full forward pass within
   2e-3 of its largest logit for 16 steps (the reference's property).
9. Prints one JSON line of the rows at shapes or types the paths do not
   run (launches 0), then the ``{"kernels": [...]}`` line: one row for
   each kernel at each shape and type its path runs, with its launches
   there, error and times; then the line ``kernels: ...``, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; nothing is caught. Without CUDA,
or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import collections
import json
import re
import shutil
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
# TF32 on the tensor cores (dense, same sheet), three products a value:
# the rate of the wkv6 sequence kernel's fp32-exact products
H100_TF32X3_FLOP_PER_S = 495e12 / 3
# per coefficient and frame beyond the transforms' 4 x 16 multiply-adds:
# residual, step (qstep * w), divide, round, abs, 1 + |q|, log2, the bit
# cost's multiply-add (2), nonzero test, bit sum, dequantize, add to the
# reference
ELEMENTWISE_FLOP = 13
L2_FLUSH_BYTES = 128 << 20  # read between timed calls: 2.5x the L2 cache
CHUNK_FRAMES, SCENE_FRAMES, HEIGHT, WIDTH_PX = 10, 30, 384, 640
KERNEL_SOURCE = "src/repro_torch/kernels/mbcodec/csrc/mbcodec.cu"
ACCGRAD_SOURCE = ("src/repro_torch/kernels/accgrad_reduce/csrc/"
                  "accgrad_reduce.cu")
# the pl.pallas_call line of each TPU kernel
REPLACES = {"mbcodec_frame": "src/repro/kernels/mbcodec/kernel.py:216",
            "mbcodec_chunk": "src/repro/kernels/mbcodec/kernel.py:147",
            "mbcodec_chunk_scores": "src/repro/kernels/mbcodec/kernel.py:184",
            "accgrad_reduce": "src/repro/kernels/accgrad_reduce/kernel.py:34",
            "decode_attn": "src/repro/kernels/decode_attn/kernel.py:59",
            "wkv6": "src/repro/kernels/wkv6/kernel.py:71"}
DECODE_ATTN_SOURCE = "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu"
WKV6_SOURCE = "src/repro_torch/kernels/wkv6/csrc/wkv6.cu"
# LM serving: batch 16, prompts of 1024 tokens, cache room for 2048, 64
# greedy steps; decode against forward in fp32 after a 256-token prefill
LM_ARCHS = ("smollm-360m", "rwkv6-1.6b")
LM_BATCH, LM_PROMPT, LM_MAX_SEQ, LM_STEPS = 16, 1024, 2048, 64
LM_CHECK_BATCH, LM_CHECK_PREFILL, LM_CHECK_STEPS = 4, 256, 16
LM_DECODE_REL = 2e-3  # tests/test_models.py's bound
DECODE_32K = (128, 32768)  # the reference's decode_32k cell: batch, length
ATTN_TOL = (1e-5, 1e-4)  # atol, rtol: the reference's kernel bounds
# device positions of the decode_attn graph check: the first, 255 and 256,
# the path's last decode step and the cache's last position
GRAPH_POSITIONS = (0, 255, 256, LM_PROMPT + 63, LM_MAX_SEQ - 1)
WKV_TOL = (2e-4, 1e-3)
CARD = ""  # nvidia-smi's name and power limit, set once by main()
BACKENDS = ("exact", "pallas", "fused", "fused_exact")
FLEET_SEEDS = range(300, 308)  # as benchmarks/multistream.py
FLEET_RUNS = (("exact", True), ("fused", True), ("fused_exact", True),
              ("fused", False))
FLEET_ACC_GAP = 0.05  # fleet vs sequential, per stream-chunk (see below)
# training: 2 dashcam scenes of 8 frames, labelled 4 frames per batch with
# the reference trainer's defaults (qp 30 / 40, label_alpha 0.1)
TRAIN_SEED, TRAIN_SCENES, TRAIN_SCENE_FRAMES, HELD_SEED = 200, 2, 8, 210
LABEL_BATCH, LABEL_ALPHA, TRAIN_EPOCHS, DNN_STEPS = 4, 0.1, 15, 400
ACCGRAD_RTOL = 1e-5  # per macroblock sum: summation order only
# an array on the host may appear only where data crosses to or from the
# card: the copy itself, numpy input wrapped before its copy (lift_fresh),
# the detach that .numpy() does on the host copy, and the pinning of the
# host staging buffer the fleet engine copies from. 0-dim host tensors
# are wrapped Python scalars, which PyTorch passes along with CUDA
# operands.
TRANSFER_OPS = {"aten._to_copy.default", "aten.copy_.default",
                "aten.lift_fresh.default", "aten.detach.default",
                "aten._pin_memory.default", "aten.pin_memory.default",
                "aten.is_pinned.default"}


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


def roofline_ms(moved, flop, rate=H100_FP32_FLOP_PER_S):
    """Least time for a call that moves ``moved`` bytes and does ``flop``
    operations: the bytes at the memory rate or the operations at ``rate``
    (the fp32 CUDA-core rate unless the kernel's products run elsewhere),
    whichever is larger, and which it is."""
    t_bytes, t_ops = moved / H100_BYTES_PER_S, flop / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_cold_ms(fn, iters=20, reps=10):
    """Device ms per call of ``fn`` with its inputs in device memory rather
    than in the 50 MB L2 cache: each call follows a read of 128 MB, and
    those reads alone, timed the same way, are subtracted. A kernel whose
    inputs fit in L2 is otherwise timed on inputs the previous call left
    there, which can beat a bound set by the memory rate."""
    scratch = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")

    def flush():
        return scratch.sum()

    def both():
        flush()
        fn()

    return time_ms(both, iters, reps)[0] - time_ms(flush, iters, reps)[0]


def codec_bytes(T, N, qp_bytes):
    """Bytes one codec call on T frames of N blocks (all streams' frames
    counted in T) must move, QP inputs taking ``qp_bytes``: blocks and
    rec, bits, D and w, 4 bytes each, each read or written once."""
    return 4 * (2 * T * N * 256 + T * N + 2 * 256) + qp_bytes


def bound_ms(T, N, qp_bytes):
    """Least time for that call: :func:`codec_bytes` against its
    transforms' and quantizer's operations."""
    flop = T * N * 4 * 2 * 16 ** 3 + T * N * 256 * ELEMENTWISE_FLOP
    return roofline_ms(codec_bytes(T, N, qp_bytes), flop)


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
                                                 mbcodec_chunk_rowcol,
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
            lambda q=False: mbcodec_ref(blocks[0], qp[0], want_q=q), 1,
            False)}
    for clip in (False, True):
        variants[K.chunk_kernel_name(clip)] = (
            lambda q=False, c=clip: K.mbcodec_chunk_cuda(blocks, qp, c,
                                                         want_q=q),
            lambda q=False, c=clip: mbcodec_chunk_ref(blocks, qp, c,
                                                      want_q=q), T, clip)
    rows = {}
    for name, (kern, plain, frames_in, clip) in variants.items():
        got, want = kern(True), plain(True)
        torch.cuda.synchronize()
        if frames_in == 1:
            got, want = ([t[None] for t in x] for x in (got, want))
        max_err = check_kernel(name, got, want)
        check_kernel(f"{name} vs its row/column twin", got,
                     mbcodec_chunk_rowcol(blocks[:frames_in], qp[:frames_in],
                                          clip, want_q=True))
        if frames_in == 1:  # the frame entry point: the chunk kernel at T=1
            chunk = K.mbcodec_chunk_cuda(blocks[:1], qp[:1], False,
                                         want_q=True)
            torch.cuda.synchronize()
            differ = [int((a != b).sum()) for a, b in zip(got, chunk)]
            log(f"  {name} vs mbcodec_chunk at T = 1: elements differing in "
                f"rec, bits, q: {differ}"
                + (" (bit-identical)" if not any(differ) else ""))
            if any(differ):
                raise AssertionError(f"{name} is not mbcodec_chunk at T = 1")
        rows[name] = timed_row(name, kern, plain, max_err,
                               bound_ms(frames_in, N, 4 * frames_in * N),
                               moved=codec_bytes(frames_in, N,
                                                 4 * frames_in * N))
    # the chunk kernel over 1 to T frames: what a launch costs beyond the
    # per-frame work, which a single frame (the frame entry point) pays;
    # and one thread block's frame alone, the latency of the body
    by_t = {t: time_ms(lambda t=t: K.mbcodec_chunk_cuda(blocks[:t], qp[:t],
                                                        False))[0]
            for t in (1, 2, 5, T)}
    per_frame = (by_t[T] - by_t[1]) / (T - 1)
    one_cta = time_ms(lambda: K.mbcodec_chunk_cuda(blocks[:1, :8],
                                                   qp[:1, :8], False))[0]
    log(f"  {K.chunk_kernel_name(False)} by frames ({CARD}): "
        + ", ".join(f"T={t} {ms:.4f} ms" for t, ms in by_t.items())
        + f"; {per_frame:.4f} ms a further frame, "
        f"{by_t[1] - per_frame:.4f} ms fixed a launch (T=1 less that); "
        f"one thread block (8 blocks) at T=1 {one_cta:.4f} ms")
    return rows


def timed_row(name, kern, plain, max_err, bound, source=KERNEL_SOURCE,
              cold=False, library=None, iters=20, reps=10, moved=None):
    """The kernels-line row of ``name``, both versions timed here (and
    ``library``, one PyTorch call computing the same function, where there
    is one); with ``cold``, the row's times (the library's too) are
    :func:`time_cold_ms`'s and the times on inputs left in L2 by the
    previous call are logged beside them. Logs the kernel's share of its
    bound and, given the ``moved`` bytes, its rate."""
    (ms, eager), (plain_ms, plain_eager) = (time_ms(kern, iters, reps),
                                            time_ms(plain, iters, reps))
    lib_ms = time_ms(library, iters, reps)[0] if library else None
    b_ms, b_by = bound
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        + (f"library {lib_ms:.4f} ms, " if library else "")
        + f"bound {b_ms:.4f} ms ({b_by}); called eagerly: kernel "
        f"{eager:.4f} ms, plain {plain_eager:.4f} ms ({CARD})")
    if cold:
        ms, plain_ms = time_cold_ms(kern), time_cold_ms(plain)
        lib_ms = time_cold_ms(library) if library else None
        log(f"  {name}, inputs in device memory (L2 flushed before each "
            f"call): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + (f", library {lib_ms:.4f} ms" if library else ""))
    log(f"  {name}: kernel at {b_ms / ms:.3f} of its bound"
        + (f", {moved / ms / 1e6:.1f} GB/s" if moved else "")
        + (f"; library at {b_ms / lib_ms:.3f}" if library else ""))
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name.split("[")[0]],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def scores_kernel_phase(fleet_chunk):
    """The stream-batched scores kernel at the fleet path's shapes (8
    streams, T=10, N=2880) against its plain version, and against the
    explicit-array chunk kernel fed the QP map its threshold implies (one
    kernel body: expected bit-identical)."""
    from repro_torch.kernels.mbcodec import kernel as K
    from repro_torch.kernels.mbcodec.ops import _chunk_blocks
    from repro_torch.kernels.mbcodec.ref import (mbcodec_chunk_rowcol,
                                                 mbcodec_chunk_scores_ref,
                                                 scores_qp)

    blocks, n_mb, C = _chunk_blocks(fleet_chunk)
    S, T, N = blocks.shape[:3]
    rng = np.random.default_rng(1)
    pooled = rng.random((S, n_mb), dtype=np.float32)
    pooled[:, 0] = 0.5  # alpha exactly on a score: >= takes qp_hi
    pooled = torch.from_numpy(pooled).cuda()
    knobs = torch.tensor([0.5, 30.0, 40.0]).cuda()
    log(f"scores kernel phase: S={S} streams, T={T}, N={N} blocks "
        f"({S * N} thread blocks per launch)")

    def fold(x):  # (S, T, N, ...) -> (T, S*N, ...) for check_kernel
        return x.transpose(0, 1).reshape((T, S * N) + tuple(x.shape[3:]))

    rows = {}
    for clip in (False, True):
        name = K.scores_kernel_name(clip)

        def kern(q=False, c=clip):
            return K.mbcodec_chunk_scores_cuda(blocks, pooled, knobs, C, c,
                                               want_q=q)

        def plain(q=False, c=clip):
            return mbcodec_chunk_scores_ref(blocks, pooled, knobs, C, c,
                                            want_q=q)

        got, want = kern(True), plain(True)
        torch.cuda.synchronize()
        max_err = check_kernel(name, [fold(t) for t in got],
                               [fold(t) for t in want])
        qp = scores_qp(pooled, knobs, C)
        twin = mbcodec_chunk_rowcol(blocks.transpose(0, 1),
                                    qp[None].expand(T, S, N), clip,
                                    want_q=True)
        check_kernel(f"{name} vs its row/column twin",
                     [fold(t) for t in got],
                     [t.reshape((T, S * N) + tuple(t.shape[3:]))
                      for t in twin])
        del twin
        explicit = [K.mbcodec_chunk_cuda(
            blocks[s], qp[s].expand(T, N).contiguous(), clip, want_q=True)
            for s in range(S)]
        explicit = [torch.stack(t) for t in zip(*explicit)]
        torch.cuda.synchronize()
        differ = [int((a != b).sum()) for a, b in zip(got, explicit)]
        log(f"  {name} vs mbcodec_chunk on the implied QP map: elements "
            f"differing in rec, bits, q: {differ}"
            + (" (bit-identical)" if not any(differ) else ""))
        if any(differ):
            check_kernel(f"{name} vs mbcodec_chunk", [fold(t) for t in got],
                         [fold(t) for t in explicit])
        rows[name] = timed_row(name, kern, plain, max_err,
                               bound_ms(S * T, N, 4 * S * n_mb + 12),
                               moved=codec_bytes(S * T, N,
                                                 4 * S * n_mb + 12))
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


def models():
    from repro_torch.core.accmodel import AccModel
    from repro_torch.vision.dnn import FinalDNN

    g = torch.Generator().manual_seed(0)
    return (FinalDNN("detection", width=32, generator=g, device="cuda"),
            AccModel(width=16, generator=g, device="cuda"))


def median_alpha(am, first_frame):
    """Untrained scores are nearly uniform, and dilation would spread any
    raw-score threshold over almost every block; since dilate(s >= a) is
    dilate_scores(s) >= a, the median of the first frame's dilated scores
    as alpha puts about half the blocks at each QP level."""
    from repro_torch.core.quality import dilate_scores

    return float(dilate_scores(am.scores(first_frame), 2).median())


def launch_counts():
    """Every kernel's launch count so far, all kernel packages."""
    from repro_torch.kernels.accgrad_reduce import kernel as accgrad
    from repro_torch.kernels.decode_attn import kernel as decode_attn
    from repro_torch.kernels.mbcodec import kernel as mbcodec
    from repro_torch.kernels.wkv6 import kernel as wkv6

    return {**mbcodec.LAUNCHES, **accgrad.LAUNCHES, **decode_attn.LAUNCHES,
            **wkv6.LAUNCHES}


def audited(run):
    """``run()`` under the device audit and the launch counters -> (its
    result, the launches it made, the ops it ran off the card)."""
    before = launch_counts()
    audit = DeviceAudit()
    with audit:
        out = run()
    torch.cuda.synchronize()
    moved = {k: v - before.get(k, 0) for k, v in launch_counts().items()
             if v != before.get(k, 0)}
    return out, moved, audit.off_card


def main_path_phase(scene_frames, rows, dnn, am):
    from repro_torch.codec.codec import CHUNK_ENCODERS
    from repro_torch.core.pipeline import make_reference
    from repro_torch.core.quality import QualityConfig, qp_map_from_scores
    from repro_torch.engine import AccMPEGPolicy, StreamingEngine
    from repro_torch.kernels.mbcodec.kernel import LAUNCHES, chunk_kernel_name

    refs = make_reference(scene_frames, dnn, qp_hi=30)
    alpha = median_alpha(am, scene_frames[:1])
    qcfg = QualityConfig(alpha=alpha, gamma=2)
    log(f"single-stream path: {scene_frames.shape[0]} frames of "
        f"{scene_frames.shape[1]}x{scene_frames.shape[2]}, detection "
        f"FinalDNN width 32, AccModel width 16, alpha {alpha:.6f}, gamma 2")

    uses = {"exact": None, "pallas": "mbcodec_frame",
            "fused": chunk_kernel_name(False),
            "fused_exact": chunk_kernel_name(True)}
    LAUNCHES.clear()  # every count to 0 just before the path
    results, off_card = {}, set()
    for impl in BACKENDS:
        results[impl], moved, off = audited(
            lambda: StreamingEngine(dnn, impl=impl).run(
                AccMPEGPolicy(am, qcfg), scene_frames, refs=refs))
        log(f"  {impl}: launches {moved}")
        off_card |= off
        expect = uses[impl]
        if set(moved) != ({expect} if expect else set()):
            raise AssertionError(f"{impl} launched {moved}, expected "
                                 f"only {expect}")
    launches = dict(LAUNCHES)  # read just after the path
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
    for name in ("mbcodec_frame", chunk_kernel_name(False),
                 chunk_kernel_name(True)):
        rows[name]["launches"] = launches.get(name, 0)
        if rows[name]["launches"] < 1:
            raise AssertionError(f"{name} never launched on its path")

    # where one chunk's encode spends its time: the pallas backend (one
    # launch a frame) against fused (one a chunk), on the policy's QP maps
    chunk = scene_frames[:CHUNK_FRAMES]
    qmaps, _ = qp_map_from_scores(am.scores(chunk[:1]), qcfg)
    for impl in ("pallas", "fused"):
        encode = CHUNK_ENCODERS.resolve(impl)
        encode(chunk, qmaps)  # warm
        _profiled(f"{impl} encode of one chunk",
                  lambda: float(encode(chunk, qmaps)[1].sum()), ("chunk", 1))


def fleet_phase(fleet_frames, rows, dnn, am):
    """``MultiStreamEngine.run`` over the 8-stream fleet at full size."""
    from repro_torch.core.pipeline import NetworkConfig, make_reference
    from repro_torch.core.quality import QualityConfig
    from repro_torch.engine import (AccMPEGPolicy, EngineConfig,
                                    MultiStreamEngine, StreamingEngine)
    from repro_torch.kernels.mbcodec.kernel import (LAUNCHES,
                                                    scores_kernel_name)

    N, T = fleet_frames.shape[:2]
    n_chunks = T // CHUNK_FRAMES
    refs = [make_reference(f, dnn, qp_hi=30) for f in fleet_frames]
    alpha = median_alpha(am, fleet_frames[0, :1])
    qcfg = QualityConfig(alpha=alpha, gamma=2)
    log(f"fleet path: {N} dashcam streams (seeds {FLEET_SEEDS.start}-"
        f"{FLEET_SEEDS.stop - 1}) of {T} frames of "
        f"{fleet_frames.shape[2]}x{fleet_frames.shape[3]}, same models, "
        f"alpha {alpha:.6f} (stream 0's median rule), gamma 2")

    LAUNCHES.clear()  # every count to 0 just before the path
    results, off_card = {}, set()
    for impl, overlap in FLEET_RUNS:
        results[impl, overlap], moved, off = audited(
            lambda: MultiStreamEngine(dnn, am, config=EngineConfig(
                qcfg=qcfg, impl=impl, overlap=overlap)).run(
                fleet_frames, refs=refs))
        off_card |= off
        # each chunk, plus the warm-up: one step, and one timed hot step
        # when overlapped
        expect = {} if impl == "exact" else {
            scores_kernel_name(impl == "fused_exact"):
                n_chunks + (2 if overlap else 1)}
        log(f"  {impl} overlap={overlap}: launches {moved}")
        if moved != expect:
            raise AssertionError(f"{impl} overlap={overlap} launched "
                                 f"{moved}, expected {expect}")
    launches = dict(LAUNCHES)  # read just after the path
    if off_card:
        raise AssertionError(f"ops off the card: {sorted(off_card)}")
    log("  every op of the four fleet runs ran on cuda (transfers aside)")

    for (impl, overlap), r in results.items():
        acc = [c.accuracy for s in r.streams for c in s.chunks]
        nbytes = [c.bytes for s in r.streams for c in s.chunks]
        if r.n_streams != N or len(acc) != N * n_chunks or not all(
                np.isfinite(acc + nbytes)) or not all(
                0.0 <= a <= 1.0 for a in acc) or min(nbytes) <= 0:
            raise AssertionError(f"{impl}: malformed fleet result")

    def per_chunk(r, field):
        return np.array([[getattr(c, field) for c in s.chunks]
                         for s in r.streams])

    # a second run of each, outside the audit (whose Python hook on every
    # op would dominate the host clock), gives the timings
    for impl, overlap in FLEET_RUNS:
        r = MultiStreamEngine(dnn, am, config=EngineConfig(
            qcfg=qcfg, impl=impl, overlap=overlap)).run(fleet_frames,
                                                        refs=refs)
        for field in ("accuracy", "bytes"):
            if not np.array_equal(per_chunk(r, field),
                                  per_chunk(results[impl, overlap], field)):
                raise AssertionError(f"{impl} overlap={overlap}: a second "
                                     f"run differs in {field}")
        t = r.timing
        busy = (sum(t.camera_s) + sum(t.server_s)) / t.wall_s
        log(f"  {impl} overlap={overlap} summary: {json.dumps(r.summary())}"
            f" stages: {json.dumps(t.summary())} device-stage share of "
            f"wall {busy:.4f}")

    exact_b = per_chunk(results["exact", True], "bytes")
    rel = np.abs(per_chunk(results["fused_exact", True], "bytes")
                 - exact_b) / exact_b
    log(f"  fused_exact fleet bytes within {rel.max():.3e} of exact per "
        f"stream and chunk")
    if rel.max() > 1e-3:
        raise AssertionError("fused_exact fleet bytes differ from exact")

    fused, serial = results["fused", True], results["fused", False]
    for field in ("accuracy", "bytes"):
        if not np.array_equal(per_chunk(fused, field),
                              per_chunk(serial, field)):
            raise AssertionError(f"overlapped and serialized fused fleets "
                                 f"differ in {field}")
    log("  overlapped and serialized fused fleets: identical accuracy and "
        "bytes")

    # 8 single-stream runs of the same backend. Their AccModel sees one
    # frame per call where the fleet's sees 8, and their server DNN 10
    # frames where the fleet's sees 80; cuDNN may pick other algorithms,
    # so a score at alpha or a detection at a threshold can move.
    net = NetworkConfig.shared(2.5e6, N)
    seq = [StreamingEngine(dnn, net=net, impl="fused").run(
        AccMPEGPolicy(am, qcfg), fleet_frames[i], refs=refs[i])
        for i in range(N)]
    seq_acc = np.array([[c.accuracy for c in r.chunks] for r in seq])
    seq_b = np.array([[c.bytes for c in r.chunks] for r in seq])
    heads = torch.from_numpy(fleet_frames[:, ::CHUNK_FRAMES]).cuda()
    batched = torch.stack([am.scores(heads[:, ci])
                           for ci in range(n_chunks)])
    single = torch.stack([torch.cat([am.scores(heads[i, ci][None])
                                     for i in range(N)])
                          for ci in range(n_chunks)])
    log(f"  AccModel scores, one frame per call vs {N} per call: max abs "
        f"difference {float((batched - single).abs().max()):.3e}")
    gap = np.abs(per_chunk(fused, "accuracy") - seq_acc)
    rel = np.abs(per_chunk(fused, "bytes") - seq_b) / seq_b
    log(f"  fused fleet vs {N} single-stream fused runs: bytes within "
        f"{rel.max():.3e} per stream and chunk; accuracy gap max "
        f"{gap.max():.3e}, mean {gap.mean():.3e} (bound {FLEET_ACC_GAP})")
    if rel.max() > 1e-3:
        raise AssertionError("fleet bytes differ from single-stream runs")
    if gap.max() > FLEET_ACC_GAP:
        raise AssertionError("fleet accuracy differs from single-stream "
                             "runs")
    for clip in (False, True):
        name = scores_kernel_name(clip)
        rows[name]["launches"] = launches.get(name, 0)
        if rows[name]["launches"] < 1:
            raise AssertionError(f"{name} never launched on its path")


def accgrad_kernel_phase():
    """``accgrad_reduce`` at the label batch's shape (B=4, 384x640x3)
    against its plain version on seeded inputs."""
    from repro_torch.kernels.accgrad_reduce.kernel import accgrad_reduce_cuda
    from repro_torch.kernels.accgrad_reduce.ref import accgrad_reduce_ref

    shape = (LABEL_BATCH, HEIGHT, WIDTH_PX, 3)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    hq, lq = (torch.from_numpy(rng.random(shape, dtype=np.float32))
              for _ in range(2))
    g, hq, lq = g.cuda(), hq.cuda(), lq.cuda()
    log(f"accgrad kernel phase: (B, H, W, C) = {shape}")

    def kern():
        return accgrad_reduce_cuda(g, hq, lq)

    def plain():
        return accgrad_reduce_ref(g, hq, lq)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want).max())  # every sum is > 0 here
    log(f"  accgrad_reduce: {got.numel()} macroblock sums, max abs "
        f"{max_err:.3e}, max rel {rel:.3e} (bound {ACCGRAD_RTOL})")
    if got.shape != want.shape or rel > ACCGRAD_RTOL:
        raise AssertionError("accgrad_reduce disagrees with its plain "
                             "version")
    # three inputs read once, the sums written once; per input element
    # abs, subtract, abs and two adds, per pixel the product and its add
    moved = 4 * (3 * g.numel() + got.numel())
    flop = 5 * g.numel() + 2 * g.numel() // g.shape[-1]
    return {"accgrad_reduce": timed_row(
        "accgrad_reduce", kern, plain, max_err, roofline_ms(moved, flop),
        ACCGRAD_SOURCE, cold=True)}


def check_labels(labels, reductions):
    """``make_labels``' labels against labels built from the same gradients
    (``reductions``: the (g, hq, lq, kernel sums) of each batch) through
    the plain reduction. A label may differ only where the plain
    normalised AccGrad lies within ``ACCGRAD_RTOL`` of the threshold."""
    from repro_torch.kernels.accgrad_reduce.ref import accgrad_reduce_ref

    def normalised(grid):
        return grid / grid.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-12)

    kern = torch.cat([out for *_, out in reductions])
    plain = torch.cat([accgrad_reduce_ref(g, hq, lq)
                       for g, hq, lq, _ in reductions])
    rel = float(((kern - plain).abs() / plain.clamp_min(1e-30)).max())
    plain_ag = normalised(plain)
    flips = (plain_ag >= LABEL_ALPHA) != labels
    near = (plain_ag - LABEL_ALPHA).abs() <= ACCGRAD_RTOL
    log(f"  labels {tuple(labels.shape)}, positive share "
        f"{float(labels.float().mean()):.4f}; kernel sums vs plain on the "
        f"path's gradients: max rel {rel:.3e}; label flips against the "
        f"plain reduction {int(flips.sum())}, all within {ACCGRAD_RTOL} of "
        f"alpha: {int(near.sum())} such blocks")
    if rel > ACCGRAD_RTOL:
        raise AssertionError("accgrad_reduce disagrees with its plain "
                             "version on the path's gradients")
    if bool((flips & ~near).any()):
        raise AssertionError("labels flip away from the threshold")


def training_phase(rows, dnn):
    """The offline training path at full size: AccGrad labels through the
    kernel, both AccModel trainers, and the final DNN's trainer."""
    from repro_torch.core import accgrad
    from repro_torch.core.training import (make_labels, train_accmodel,
                                           train_accmodel_e2e)
    from repro_torch.data.video import make_dataset
    from repro_torch.kernels.accgrad_reduce.kernel import LAUNCHES
    from repro_torch.vision import dnn as V
    from repro_torch.vision.train import train_final_dnn

    scenes = make_dataset("dashcam", n_scenes=TRAIN_SCENES,
                          frames_per_scene=TRAIN_SCENE_FRAMES,
                          seed=TRAIN_SEED, H=HEIGHT, W=WIDTH_PX)
    frames = np.concatenate([s.frames for s in scenes])
    n = frames.shape[0]
    log(f"training path: {n} dashcam frames of {HEIGHT}x{WIDTH_PX} (seeds "
        f"{TRAIN_SEED}-{TRAIN_SEED + TRAIN_SCENES - 1}), detection FinalDNN "
        f"width 32, label batch {LABEL_BATCH}, alpha {LABEL_ALPHA}")

    # the first backward of each convolution shape loads and plans its
    # kernels; one epoch of each trainer on one batch takes that cost out
    # of the timed runs below, so that neither pays it for the other
    for trainer in (train_accmodel, train_accmodel_e2e):
        trainer(dnn, frames[:LABEL_BATCH], epochs=1, width=16)
    torch.cuda.synchronize()

    # record each reduction's inputs and sums, so that the labels can be
    # rebuilt from the same gradients through the plain version
    reduce, reductions = accgrad.accgrad_reduce, []

    def recorded(g, hq, lq):
        out = reduce(g, hq, lq)
        reductions.append((g, hq, lq, out))
        return out

    accgrad.accgrad_reduce = recorded
    LAUNCHES.clear()  # every count to 0 just before the path
    t0 = time.perf_counter()
    (hq, labels), moved, off = audited(
        lambda: make_labels(dnn, frames, 30, 40, batch=LABEL_BATCH,
                            label_alpha=LABEL_ALPHA))
    label_s = time.perf_counter() - t0
    accgrad.accgrad_reduce = reduce
    log(f"  make_labels: launches {moved}, {label_s:.3f} s under the audit")
    if moved != {"accgrad_reduce": n // LABEL_BATCH}:
        raise AssertionError(f"make_labels launched {moved}, expected "
                             f"{n // LABEL_BATCH} accgrad_reduce")
    if off:
        raise AssertionError(f"ops off the card: {sorted(off)}")
    log("  every op of make_labels ran on cuda (transfers aside)")
    if hq.shape != frames.shape or not bool(torch.isfinite(hq).all()) or \
            labels.dtype != torch.bool or \
            labels.shape != (n, HEIGHT // 16, WIDTH_PX // 16):
        raise AssertionError("malformed labels")
    check_labels(labels, reductions)

    reports = {}
    for trainer in (train_accmodel, train_accmodel_e2e):
        rep = trainer(dnn, frames, epochs=TRAIN_EPOCHS, width=16)
        reports[trainer.__name__] = rep
        log(f"  {trainer.__name__}: label_time_s {rep.label_time_s:.4f}, "
            f"train_time_s {rep.train_time_s:.4f}, per image and epoch "
            f"{rep.train_time_s / (n * TRAIN_EPOCHS) * 1e3:.4f} ms, losses "
            f"{rep.losses[0]:.6f} -> {rep.losses[-1]:.6f}")
        if not np.isfinite(rep.losses).all():
            raise AssertionError(f"{trainer.__name__}: non-finite loss")
    dec, e2e = reports["train_accmodel"], reports["train_accmodel_e2e"]
    if not dec.losses[-1] < dec.losses[0]:
        raise AssertionError(f"train_accmodel did not learn: {dec.losses}")
    log(f"  Table 2 direction, e2e / decoupled: train time per image "
        f"{e2e.train_time_s / dec.train_time_s:.3f}x, total per image "
        f"{e2e.total_time_s / dec.total_time_s:.3f}x")

    held = make_dataset("dashcam", n_scenes=1, frames_per_scene=4,
                        seed=HELD_SEED, H=HEIGHT, W=WIDTH_PX)[0]
    held_frames = torch.from_numpy(held.frames).cuda()
    targets = V.render_detection_targets(held.boxes, HEIGHT, WIDTH_PX)

    def held_loss(net):
        with torch.no_grad():
            return float(V.detection_train_loss(net, held_frames, targets))

    before = held_loss(V.init_net("detection", 0, 32))  # the trainer's start
    t0 = time.perf_counter()
    net = train_final_dnn("detection", "dashcam", steps=DNN_STEPS,
                          H=HEIGHT, W=WIDTH_PX, width=32, cache=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = held_loss(net)
    log(f"  train_final_dnn: {DNN_STEPS} steps in {secs:.3f} s (data "
        f"included); held-batch detection loss {before:.6f} -> {after:.6f}")
    if not after < before:
        raise AssertionError("train_final_dnn did not lower the held loss")
    # read just after the path: make_labels' and train_accmodel's labels
    rows["accgrad_reduce"]["launches"] = LAUNCHES["accgrad_reduce"]
    if rows["accgrad_reduce"]["launches"] != 2 * (n // LABEL_BATCH):
        raise AssertionError(f"accgrad_reduce launched "
                             f"{rows['accgrad_reduce']['launches']} times "
                             f"on the training path")


def _check_close(name, got, want, tol):
    """Max abs error of ``got`` against ``want`` (fp32); fails outside
    atol + rtol * |want| or on a non-finite output."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    log(f"  {name}: max abs err {float(err.max()):.3e}, worst excess over "
        f"atol {atol} + rtol {rtol} * |plain| {worst - atol:.3e}")
    if not bool(torch.isfinite(got).all()) or worst > atol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return float(err.max())


def decode_attn_kernel_phase():
    """``decode_attn`` against its plain version at the smollm decode
    path's shape (bf16 and fp32) and at one smollm layer of the
    reference's decode_32k cell (bf16), with ``scaled_dot_product_attention``
    on the same inputs timed as the library call."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    cfg_kv, cfg_g, hd = 5, 3, 64  # smollm-360m: 15 heads over 5 KV heads
    cases = (("path,bf16", LM_BATCH, LM_MAX_SEQ, LM_PROMPT + 63,
              torch.bfloat16),
             ("path,fp32", LM_BATCH, LM_MAX_SEQ, LM_PROMPT + 63,
              torch.float32),
             ("decode_32k,bf16", *DECODE_32K, DECODE_32K[1] - 1,
              torch.bfloat16))
    rows = {}
    for tag, B, S, pos, dtype in cases:
        gen = torch.Generator(device="cuda").manual_seed(S + pos)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((B, cfg_kv, cfg_g, hd), (B, S, cfg_kv, hd),
                                 (B, S, cfg_kv, hd)))
        name = f"decode_attn[{tag}]"
        log(f"decode_attn kernel phase {tag}: B={B}, S={S}, KV={cfg_kv}, "
            f"G={cfg_g}, hd={hd}, pos={pos}, {dtype}")

        def kern():
            return decode_attn_cuda(q, k, v, pos)

        def plain():
            return decode_attn_ref(q, k, v, pos)

        qh = q.reshape(B, cfg_kv * cfg_g, 1, hd)
        kh, vh = (t[:, :pos + 1].transpose(1, 2) for t in (k, v))

        def library():  # GQA over the valid positions, never on the path
            return F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)

        want = plain()
        max_err = _check_close(name, kern(), want, ATTN_TOL)
        lib_err = float((library().float().reshape(q.shape)
                         - want).abs().max())
        log(f"  {name}: library call vs plain, max abs {lib_err:.3e}")
        # each valid K and V row read once, q read and the output written;
        # per position and query row a dot and a weighted add of hd
        # (4 hd operations) and an exponential
        moved = (2 * B * (pos + 1) * cfg_kv * hd * k.element_size()
                 + q.numel() * q.element_size() + 4 * q.numel())
        flop = B * cfg_kv * cfg_g * (pos + 1) * (4 * hd + 2)
        # the path's 22 MB would sit in L2 between calls, where on the path
        # each layer reads its own cache from device memory: L2 flushed
        big = S > LM_MAX_SEQ  # the plain version's fp32 copies: 21 GB
        rows[name] = timed_row(name, kern, plain, max_err,
                               roofline_ms(moved, flop), DECODE_ATTN_SOURCE,
                               cold=not big, library=library,
                               reps=1 if big else 10, moved=moved)
        if tag == "path,bf16":
            _decode_attn_graph_check(q, k, v)
        del q, k, v, qh, kh, vh, want
        torch.cuda.empty_cache()
    return rows


def _decode_attn_graph_check(q, k, v):
    """One call captured in a CUDA graph with pos in a device tensor,
    replayed at several positions: each output within ``ATTN_TOL`` of the
    plain version at that pos and bit for bit an eager call with the int."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    decode_attn_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attn_cuda(q, k, v, pos)
    for p in GRAPH_POSITIONS:
        pos.fill_(p)
        graph.replay()
        _check_close(f"decode_attn[graph replay, pos={p}]", out,
                     decode_attn_ref(q, k, v, p), ATTN_TOL)
        if not torch.equal(out, decode_attn_cuda(q, k, v, p)):
            raise AssertionError(f"decode_attn: the graph's replay at pos "
                                 f"{p} differs from an eager call")
    log(f"  decode_attn: one captured graph, replayed at pos "
        f"{', '.join(map(str, GRAPH_POSITIONS))}, equals eager calls bit "
        f"for bit")


def _wkv_inputs(B, S, H, hd, seed, ld_low=None):
    """r, k, v (x0.5), log-decay (-exp(N(-1, 0.5)), or uniform in
    [ld_low, -1e-4]), u (x0.3), s0 (x0.2): the reference tests' scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (n(B, S, H, hd, scale=0.5) for _ in range(3))
    if ld_low is None:
        ld = -torch.exp(n(B, S, H, hd, scale=0.5) - 1.0)
    else:
        ld = ld_low + (-1e-4 - ld_low) * torch.rand(
            (B, S, H, hd), generator=gen, device="cuda")
    return r, k, v, ld, n(H, hd, scale=0.3), n(B, H, hd, hd, scale=0.2)


def wkv6_kernel_phase():
    """``wkv6`` against the reference model's chunked form at the rwkv6
    path's prefill (B=16, S=1024, H=32, hd=64) and decode (S=1) shapes,
    with r, k and v in bf16 as the serving path passes them and in fp32,
    and against the sequential oracle on a ragged, fast-decay slice
    (S=1000, log-decays down to -8, s0 != 0), where every output must be
    finite. The plain version reads the same bf16 values, widened."""
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv_chunked

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = (("prefill,bf16", LM_BATCH, LM_PROMPT, 32, None, bf16),
             ("decode,bf16", LM_BATCH, 1, 32, None, bf16),
             ("prefill,fp32", LM_BATCH, LM_PROMPT, 32, None, fp32),
             ("decode,fp32", LM_BATCH, 1, 32, None, fp32),
             ("ragged", 2, 1000, 4, -8.0, fp32))
    rows = {}
    for tag, B, S, H, ld_low, dtype in cases:
        hd = 64
        r, k, v, *rest = _wkv_inputs(B, S, H, hd, seed=S, ld_low=ld_low)
        xs = (r.to(dtype), k.to(dtype), v.to(dtype), *rest)
        name = f"wkv6[{tag}]"
        log(f"wkv6 kernel phase {tag}: B={B}, S={S}, H={H}, hd={hd}, r, k, "
            f"v {dtype}, the rest fp32"
            + (f", log-decay in [{ld_low}, -1e-4]" if ld_low else ""))

        def kern():
            return wkv6_cuda(*xs)

        plain = (lambda: wkv6_ref(*xs)) if ld_low else (
            lambda: wkv_chunked(*xs))
        got, want = kern(), plain()
        max_err = max(_check_close(f"{name} {part}", g, w, WKV_TOL)
                      for part, g, w in zip(("o", "state"), got, want))
        # r, k, v (in their type), log-decay and o (fp32) per token, u, s0
        # and the final state; per token and head the read-out (2 hd^2),
        # the decay and the outer-product update (3 hd^2) and the bonus and
        # exp (~6 hd)
        moved = (B * S * H * hd * (3 * xs[0].element_size() + 8)
                 + 4 * (H * hd + 2 * B * H * hd * hd))
        flop = B * S * H * (5 * hd * hd + 6 * hd)
        # S >= 2: the products on the tensor cores (TF32, three products a
        # value); a decode step on the CUDA cores
        rate = H100_TF32X3_FLOP_PER_S if S > 1 else H100_FP32_FLOP_PER_S
        rows[name] = timed_row(name, kern, plain, max_err,
                               roofline_ms(moved, flop, rate), WKV6_SOURCE,
                               iters=3 if ld_low else 20,
                               reps=1 if ld_low else 10)
    return rows


def ptxas_kernels(report):
    """nvcc's ``-Xptxas -v`` report -> one dict per kernel it compiled:
    its mangled name and its registers, static shared memory, stack frame
    and spilled bytes (None where the report gives no line)."""
    kernels = []
    for line in report.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kernels.append({"fn": m.group(1), "registers": None, "smem": 0,
                            "stack": None, "spills": None})
        if not kernels:
            continue
        k = kernels[-1]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            k["stack"] = int(m.group(1))
            k["spills"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m:
            k["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            k["smem"] = int(smem.group(1)) if smem else 0
    return kernels


def _mbcodec_label(fn):
    """``mbcodec_chunk_kernel<clip, QpSource>`` of a mangled name."""
    source = "QpFromScores" if "QpFromScores" in fn else "QpFromArray"
    return f"mbcodec_chunk_kernel<{'ILb1E' in fn}, {source}>"


def mbcodec_sass_report():
    """Logs each mbcodec instantiation's SASS (``cuobjdump -sass`` of the
    built library): its instruction count and most frequent opcodes. The
    loop over frames holds one frame's whole body, so the count is about
    one thread's instructions a frame. Checks nothing."""
    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path("mbcodec"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    for part in sass.split("Function : ")[1:]:
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
            part))
        log(f"    {_mbcodec_label(part.split()[0])} SASS: "
            f"{sum(ops.values())} instructions; "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(10)))


def mbcodec_build_report(report):
    """Logs each mbcodec kernel's registers, shared memory, stack frame and
    spills from nvcc's ``-Xptxas -v`` report; fails unless the library
    holds exactly the four ``mbcodec_chunk_kernel`` instantiations (the
    frame entry point launches one of them), none with a spill or a stack
    frame (each thread's rows live in registers)."""
    kernels = ptxas_kernels(report)
    for k in kernels:
        fn = k["fn"]
        if "mbcodec_chunk_kernel" not in fn:
            raise AssertionError(f"the mbcodec library holds {fn}, a kernel "
                                 f"other than mbcodec_chunk_kernel")
        label = _mbcodec_label(fn)
        log(f"    {label}: {k['registers']} registers, {k['smem']} B shared "
            f"memory, {k['stack']} B stack frame, {k['spills']} B spilled")
        if k["stack"] is None or k["stack"] or k["spills"]:
            raise AssertionError(f"{label}: {k['stack']} B stack frame, "
                                 f"{k['spills']} B spilled (or no ptxas "
                                 f"report)")
    if len(kernels) != 4:
        raise AssertionError(f"ptxas reported {len(kernels)} "
                             f"mbcodec_chunk_kernel instantiations, not 4")


def wkv6_build_report(report):
    """Logs each wkv6 instantiation's registers, shared memory (static, and
    the sequence kernel's dynamic) and spills from nvcc's ``-Xptxas -v``
    report; fails on any spill."""
    from repro_torch.kernels.wkv6.kernel import smem_bytes

    kernels = ptxas_kernels(report)
    for k in kernels:
        fn = k["fn"]
        kind = "seq" if "seq_kernel" in fn else "step"
        bf16 = "bfloat16" in fn
        hd = int(re.search(r"Li(\d+)E", fn).group(1))
        label = f"wkv6_{kind}_kernel<{'bf16' if bf16 else 'fp32'}, {hd}>"
        dyn = smem_bytes(hd, bf16) if kind == "seq" else 0
        log(f"    {label}: {k['registers']} registers, {k['smem']} B static "
            f"and {dyn} B dynamic shared memory, {k['spills']} B spilled")
        if k["spills"] is None or k["spills"]:
            raise AssertionError(f"{label} spills ({k['spills']} B) or has "
                                 f"no ptxas report")
    if len(kernels) != 8:
        raise AssertionError(f"ptxas reported {len(kernels)} wkv6 kernels, "
                             f"not 8")


def _param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _serve(model, prompt, max_seq, steps, marks=None):
    """Prefill ``prompt`` with room for ``max_seq`` tokens, then ``steps``
    greedy decode steps -> (generated tokens (B, steps + 1), whether every
    logit was finite, prefill seconds, decode seconds per step); each
    clock ends in a synchronize. ``marks["prefill"]``, where given, gets
    the launch counts as the prefill ends."""
    from repro_torch.serve.steps import make_decode_step, make_prefill_step

    prefill = make_prefill_step(model, model.cfg, max_seq=max_seq)
    decode = make_decode_step(model, model.cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, last = prefill({"tokens": prompt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if marks is not None:
        marks["prefill"] = launch_counts()
    finite = torch.isfinite(last).all()
    tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)
    out = [tok]
    for i in range(steps):
        cache, tok, logits = decode(cache, tok[:, None], prompt.shape[1] + i)
        finite &= torch.isfinite(logits).all()
        out.append(tok)
    torch.cuda.synchronize()
    return (torch.stack(out, dim=1), bool(finite), t1 - t0,
            (time.perf_counter() - t1) / max(steps, 1))


def _profiled(label, run, per):
    """``run()`` under ``torch.profiler``: the card's busy share of the
    window (the kernels' summed device time, one stream, over the host
    clock), the kernels that fill it, the port's own kernels and the
    host's costliest ops, each per ``per`` (steps, calls or chunks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # the kernels themselves: an op's own row would count its kernels again
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    ours = [e for e in kernels if any(k in e.key for k in (
        "wkv6_", "decode_attn_kernel", "mbcodec_chunk_kernel",
        "accgrad_reduce_kernel"))]
    host = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    log(f"  profiled {label} ({CARD}), per {per[0]}: host clock "
        f"{wall * 1e3 / per[1]:.4f} ms under the profiler, device busy "
        f"{busy * 1e3 / per[1]:.4f} ms (share {busy / wall:.4f}), "
        f"{launches / per[1]:.1f} kernel launches of {len(kernels)} "
        f"kernels; top kernels (ms): "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / per[1]:.4f}"
                    f" x{e.count / per[1]:g}" for e in top)
        + "; the port's kernels (ms): "
        + ("; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / per[1]:.4f}"
                     f" x{e.count / per[1]:g}" for e in ours) or "none")
        + "; top host ops by self time (ms): "
        + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / per[1]:.4f}"
                    f" x{e.count / per[1]:g}" for e in host))


def _profile_serving(model, prompt, steps=8):
    """One prefill and ``steps`` decode steps after it, each profiled."""
    from repro_torch.serve.steps import make_decode_step

    decode = make_decode_step(model, model.cfg)
    out = {}

    def prefill():
        out["cache"], out["last"] = model.prefill(prompt, max_seq=LM_MAX_SEQ)

    _profiled("prefill", prefill, ("call", 1))
    tok = torch.argmax(out["last"][:, -1], dim=-1).to(torch.int32)
    S = prompt.shape[1]
    out["cache"], tok, _ = decode(out["cache"], tok[:, None], S)  # warm

    def decode_steps():
        nonlocal tok
        for i in range(steps):
            out["cache"], tok, _ = decode(out["cache"], tok[:, None],
                                          S + 1 + i)

    _profiled(f"{steps} decode steps", decode_steps, ("step", steps))


def _decode_matches_forward(arch):
    """fp32 at full width: decode logits after a prefill of
    LM_CHECK_PREFILL tokens against ``hidden`` + ``logits`` over the whole
    sequence, relative to its largest |logit| (the reference's property)."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM

    cfg = get_config(arch)
    model = DecoderLM(cfg, torch.float32, torch.float32, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    S = LM_CHECK_PREFILL + LM_CHECK_STEPS
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (LM_CHECK_BATCH, S))).cuda()
    full = model.logits(model.hidden(tokens)[0])
    cache, last = model.prefill(tokens[:, :LM_CHECK_PREFILL], max_seq=S)
    errs = [(last[:, 0] - full[:, LM_CHECK_PREFILL - 1]).abs().max()]
    for t in range(LM_CHECK_PREFILL, S):
        cache, lg = model.decode(cache, tokens[:, t:t + 1], t)
        errs.append((lg[:, 0] - full[:, t]).abs().max())
    rel = float(torch.stack(errs).max() / full.abs().max())
    log(f"  {arch} fp32 decode vs forward (batch {LM_CHECK_BATCH}, prefill "
        f"{LM_CHECK_PREFILL}, {LM_CHECK_STEPS} steps): max error "
        f"{rel:.3e} of max |logit| (bound {LM_DECODE_REL})")
    if not rel < LM_DECODE_REL:
        raise AssertionError(f"{arch}: decode disagrees with the forward "
                             f"pass")


def lm_serving_phase(rows):
    """Both LM configurations at full width, bf16 weights and compute,
    random weights from a seeded generator: batch 16, 1024-token prompts,
    prefill with room for 2048, then 64 greedy decode steps. The first run
    is audited (launches, ops off the card); a second, outside the audit,
    gives prefill tokens/s and decode ms per step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import DecoderLM

    # the kernel each model's serving run launches, and the kernels-line
    # row of each stage that launches it (at that stage's shape and type)
    stages = {"smollm-360m": ("decode_attn",
                              {"decode": "decode_attn[path,bf16]"}),
              "rwkv6-1.6b": ("wkv6", {"prefill": "wkv6[prefill,bf16]",
                                      "decode": "wkv6[decode,bf16]"})}
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        model = DecoderLM(cfg, torch.bfloat16, torch.bfloat16, device="cuda",
                          generator=torch.Generator(
                              device="cuda").manual_seed(0))
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(torch.int32).cuda()
        weights = _param_bytes(model)
        log(f"LM serving {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"vocab {cfg.vocab_size}, {weights / 1e9:.3f} GB of bf16 "
            f"weights; batch {LM_BATCH}, prompt {LM_PROMPT}, cache room "
            f"{LM_MAX_SEQ}, {LM_STEPS} greedy steps")
        _serve(model, prompt[:, :8], 16, 2)  # loads cuBLAS and the kernels

        kernel, row_of = stages[arch]
        expect = {"prefill": cfg.n_layers if "prefill" in row_of else 0,
                  "decode": cfg.n_layers * LM_STEPS}
        dk.LAUNCHES.clear()  # every count to 0 just before the path
        wk.LAUNCHES.clear()
        marks = {}
        (tokens, finite, _, _), moved, off = audited(
            lambda: _serve(model, prompt, LM_MAX_SEQ, LM_STEPS, marks))
        at_prefill = marks["prefill"].get(kernel, 0)
        split = {"prefill": at_prefill,
                 "decode": moved.get(kernel, 0) - at_prefill}
        log(f"  launches {moved}: {split['prefill']} in the prefill, "
            f"{split['decode']} in the decode steps")
        if set(moved) != {kernel} or split != expect:
            raise AssertionError(f"{arch} launched {moved} ({split}), "
                                 f"expected {kernel} {expect}")
        if off:
            raise AssertionError(f"ops off the card: {sorted(off)}")
        log("  every op of the serving run ran on cuda (transfers aside)")
        if not finite or tokens.shape != (LM_BATCH, LM_STEPS + 1):
            raise AssertionError(f"{arch}: non-finite logits or malformed "
                                 f"tokens {tuple(tokens.shape)}")
        for stage, name in row_of.items():
            rows[name]["launches"] = split[stage]

        # the timed run, outside the audit (whose hook on every op would
        # dominate the host clock)
        again, _, t_prefill, t_decode = _serve(model, prompt, LM_MAX_SEQ,
                                               LM_STEPS)
        same = bool((again == tokens).all())
        # a decode step reads every weight but the untied embedding's
        # table (only its B rows), and the cache up to the step's position
        # or each layer's state (read and written)
        step_bytes = weights - (0 if cfg.tie_embeddings else
                                model.embed.emb.numel() * 2)
        last_pos = LM_PROMPT + LM_STEPS - 1
        if cfg.attn_free:
            H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_size
            state = cfg.n_layers * LM_BATCH * (H * hd * hd * 4
                                               + 2 * cfg.d_model * 2)
            step_bytes += 2 * state
        else:
            step_bytes += cfg.n_layers * 2 * LM_BATCH * (last_pos + 1) \
                * cfg.n_kv_heads * cfg.hd * 2
        log(f"  {arch} ({CARD}): prefill {LM_BATCH}x{LM_PROMPT} tokens in "
            f"{t_prefill:.4f} s, {LM_BATCH * LM_PROMPT / t_prefill:.1f} "
            f"tokens/s; decode {t_decode * 1e3:.4f} ms per step (batch "
            f"{LM_BATCH}), "
            f"{LM_BATCH / t_decode:.1f} tokens/s; a step moves at least "
            f"{step_bytes / 1e9:.4f} GB (weights and cache or state at "
            f"position {last_pos}): {step_bytes / H100_BYTES_PER_S * 1e3:.4f}"
            f" ms at 3.35 TB/s; second run's tokens identical: {same}")
        _profile_serving(model, prompt)
        del model
        torch.cuda.empty_cache()
        _decode_matches_forward(arch)
        torch.cuda.empty_cache()


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
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(CARD)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN, "
        f"float32 matmul precision 'highest'")

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name in ("mbcodec", "wkv6"):
        if name not in built:
            log(f"  {name} was built before this run: no ptxas report here")
    for name, (secs, report) in built.items():
        log(f"  nvcc {name}: {secs:.2f} s")
        if name in ("mbcodec", "wkv6"):
            (mbcodec_build_report if name == "mbcodec"
             else wkv6_build_report)(report)
            continue
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    mbcodec_sass_report()

    t0 = time.perf_counter()
    scene = make_scene("dashcam", seed=33, T=SCENE_FRAMES, H=HEIGHT,
                       W=WIDTH_PX)
    frames = torch.from_numpy(scene.frames).cuda()
    log(f"scene: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    fleet = np.stack([make_scene("dashcam", seed=s, T=SCENE_FRAMES,
                                 H=HEIGHT, W=WIDTH_PX).frames
                      for s in FLEET_SEEDS])
    log(f"fleet scenes: {time.perf_counter() - t0:.2f} s")

    rows = kernel_phase(frames[:CHUNK_FRAMES])
    rows.update(scores_kernel_phase(
        torch.from_numpy(fleet[:, :CHUNK_FRAMES]).cuda()))
    rows.update(accgrad_kernel_phase())
    dnn, am = models()
    t0 = time.perf_counter()
    main_path_phase(frames, rows, dnn, am)
    log(f"single-stream path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fleet_phase(fleet, rows, dnn, am)
    log(f"fleet path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    training_phase(rows, dnn)
    log(f"training path: {time.perf_counter() - t0:.2f} s")
    del dnn, am
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows.update(decode_attn_kernel_phase())
    rows.update(wkv6_kernel_phase())
    log(f"LM kernel phases: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lm_serving_phase(rows)
    log(f"LM serving path: {time.perf_counter() - t0:.2f} s")
    # rows at shapes or types the path does not run (fp32, decode_32k,
    # the ragged fast-decay slice): checked and timed as the others, and
    # printed on a line of their own with no launches on the path
    off_path = [dict(row, launches=0) for row in rows.values()
                if "launches" not in row]
    log(json.dumps({"kernel_shapes_off_path": off_path}))
    log(json.dumps({"kernels": [row for row in rows.values()
                                if "launches" in row]}))
    log("kernels: mbcodec_frame, mbcodec_chunk, mbcodec_chunk_scores, "
        "accgrad_reduce, decode_attn, wkv6")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
