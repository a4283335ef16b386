"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py      # from the repository root, on a CUDA host

1. Prints the card's name and power limit, and builds the CUDA kernels
   from ``src/repro_torch/kernels`` with nvcc into ``build/kernels/``.
2. Kernel phase: each kernel (``mbcodec_frame``, ``mbcodec_chunk`` with
   and without the reference clip, and ``mbcodec_chunk_scores`` with and
   without it) runs at its path's shapes (T=10 frames, N=2880 blocks; 8
   streams for the scores kernel) against its plain PyTorch version on
   the same inputs; it must agree (see ``check_kernel``) and both are
   timed with CUDA events. The scores kernel is also held against the
   explicit-array chunk kernel fed the QP map its threshold implies.
3. Single-stream path: the AccMPEG loop,
   ``StreamingEngine.run(AccMPEGPolicy)``, at full size (dashcam scene,
   30 frames of 384x640, detection FinalDNN width 32, AccModel width 16,
   weights drawn from a seeded ``torch.Generator``) under the codec
   backends exact, pallas, fused and fused_exact. Each run's kernel
   launches are counted, every op is checked to run on the card, and the
   kernel backends' bytes are held against exact's.
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
7. Prints one JSON line with each kernel's launches, error and times, the
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
L2_FLUSH_BYTES = 128 << 20  # read between timed calls: 2.5x the L2 cache
CHUNK_FRAMES, SCENE_FRAMES, HEIGHT, WIDTH_PX = 10, 30, 384, 640
KERNEL_SOURCE = "src/repro_torch/kernels/mbcodec/csrc/mbcodec.cu"
ACCGRAD_SOURCE = ("src/repro_torch/kernels/accgrad_reduce/csrc/"
                  "accgrad_reduce.cu")
# the pl.pallas_call line of each TPU kernel
REPLACES = {"mbcodec_frame": "src/repro/kernels/mbcodec/kernel.py:216",
            "mbcodec_chunk": "src/repro/kernels/mbcodec/kernel.py:147",
            "mbcodec_chunk_scores": "src/repro/kernels/mbcodec/kernel.py:184",
            "accgrad_reduce": "src/repro/kernels/accgrad_reduce/kernel.py:34"}
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


def roofline_ms(moved, flop):
    """Least time for a call that moves ``moved`` bytes and does ``flop``
    fp32 operations: the bytes at the memory rate or the operations at the
    CUDA-core rate, whichever is larger, and which it is."""
    t_bytes, t_ops = moved / H100_BYTES_PER_S, flop / H100_FP32_FLOP_PER_S
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


def bound_ms(T, N, qp_bytes):
    """Least time for one codec call on T frames of N blocks (all streams'
    frames counted in T) whose QP inputs take ``qp_bytes``, each input
    read once and each output written once."""
    coefs = T * N * 256
    # blocks and rec, bits, D and w; 4 bytes each
    moved = 4 * (2 * coefs + T * N + 2 * 256) + qp_bytes
    flop = T * N * 4 * 2 * 16 ** 3 + coefs * ELEMENTWISE_FLOP
    return roofline_ms(moved, flop)


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
        rows[name] = timed_row(name, kern, plain, max_err,
                               bound_ms(frames_in, N, 4 * frames_in * N))
    return rows


def timed_row(name, kern, plain, max_err, bound, source=KERNEL_SOURCE,
              cold=False):
    """The kernels-line row of ``name``, both versions timed here; with
    ``cold``, the row's times are :func:`time_cold_ms`'s and the times on
    inputs left in L2 by the previous call are logged beside them."""
    (ms, eager), (plain_ms, plain_eager) = time_ms(kern), time_ms(plain)
    b_ms, b_by = bound
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); called eagerly: kernel "
        f"{eager:.4f} ms, plain {plain_eager:.4f} ms")
    if cold:
        ms, plain_ms = time_cold_ms(kern), time_cold_ms(plain)
        log(f"  {name}, inputs in device memory (L2 flushed before each "
            f"call): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name.split("[")[0]],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def scores_kernel_phase(fleet_chunk):
    """The stream-batched scores kernel at the fleet path's shapes (8
    streams, T=10, N=2880) against its plain version, and against the
    explicit-array chunk kernel fed the QP map its threshold implies (one
    ``encode_block`` body: expected bit-identical)."""
    from repro_torch.kernels.mbcodec import kernel as K
    from repro_torch.kernels.mbcodec.ops import _chunk_blocks
    from repro_torch.kernels.mbcodec.ref import (mbcodec_chunk_scores_ref,
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
                               bound_ms(S * T, N, 4 * S * n_mb + 12))
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
    """Every kernel's launch count so far, both kernel packages."""
    from repro_torch.kernels.accgrad_reduce import kernel as accgrad
    from repro_torch.kernels.mbcodec import kernel as mbcodec

    return {**mbcodec.LAUNCHES, **accgrad.LAUNCHES}


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
    from repro_torch.core.pipeline import make_reference
    from repro_torch.core.quality import QualityConfig
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
    log(json.dumps({"kernels": list(rows.values())}))
    log("kernels: mbcodec_frame, mbcodec_chunk, mbcodec_chunk_scores, "
        "accgrad_reduce")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
