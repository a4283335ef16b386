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
5. Closed-loop fleet: ``MultiStreamEngine.serve_loop`` under churn over 12
   dashcam streams (the fleet's seeds and four more) of 60 frames of
   384x640, a segmentation FinalDNN of width 32 (random, seeded) as server
   and the fleet's AccModel; the churn is ``make_workload``'s (seed 15, at
   most 8 streams at once), with joins and leaves that move the padded
   shape between 8 and 2 lanes. Run 1: ``fused_exact``,
   ``detail="windowed"`` (the accuracy reduced on the card), a constant
   uplink, ``sim_encode_s``. Run 2: the same schedule under ``exact`` and
   under ``fused_exact``, per-chunk results scored on the host. Run 3:
   ``fused`` on an lte trace that recovers after a slow half second, with
   the ``RateController`` (budget 0.2 s), the ``FleetAutoscaler`` (its
   buffer depth held at 2, which fixes the controller's feedback lag) and
   the telemetry plane on. Run 4: a second
   schedule through run 3's engine over the same shapes in another order.
   Runs 1, 3 and 4 are audited: their ``mbcodec_chunk_scores`` launches
   must be exactly one a served interval plus the warm-ups of each newly
   admitted shape (none in run 4, where the engine builds nothing new),
   every op on the card, the lane masks and knob tensors set under sync
   debug mode "error". Padded lanes must send 0 bytes and never reach the
   aggregator; run 1's bytes must be within rtol 1e-3 of exact's per
   stream-chunk, its accuracy within 1e-2 of exact's per stream-chunk and
   5e-4 pooled (exact's frames differ where a round-half flip moves a
   block), and its windowed mean accuracy within 1e-5 of the host-scored
   mean of the ``fused_exact`` run, which decodes the same frames; run 3
   must give finite results, SLO attainment in [0, 1], a controller that
   both cuts and raises its level (qp_hi moves at least twice, both ways)
   and telemetry counters equal to ``FleetTiming``'s sums. It logs the shapes, decisions, knob
   path, stage summaries, the device-stage share of wall and the host stage
   ms an interval, windowed against chunks, from unaudited runs.
6. Multi-tenant fleet: server DNNs of width 32 and AccModels of width 16
   (seeded), 384x640, alpha by the median rule. Calibration:
   ``calibrate_tenant`` onboards a segmentation server on 16 surf frames
   into a temporary cache, twice: the first call trains (exactly 4
   ``accgrad_reduce`` launches, every op on the card but the AccModel's
   seeded initial weights, drawn on the host as every module of the port
   draws them), the second restores (no launch) bit for bit the same
   weights. Run A (``benchmarks/multitenant.py``'s settings): a detection
   tenant (the fleet's models, 5 dashcam streams, seeds 300-304) and the
   calibrated segmentation tenant (3 surf streams) share one quality
   config on one 8-lane fleet under ``fused_exact`` (``serve_loop``,
   ``FleetAutoscaler``, ``sim_encode_s`` 0.05, a 2.5 Mb/s uplink), against
   the two dedicated fleets (8 + 4 lanes) at the pro-rata uplink: per
   tenant accuracy within 5e-4 pooled and 1e-2 a stream-chunk, bytes
   within rtol 1e-3 a stream-chunk; exactly one ``mbcodec_chunk_scores``
   launch a served interval plus the warm-ups; every op on the card, the
   tenant ids and lane masks set under sync debug mode "error"; every
   decision's ``tenant_share`` (0.625, 0.375). Run B: segmentation (QP 30
   / 40) and keypoint (30 / 51) tenants under ``pallas``, windowed with
   the tenant accuracy reduce on the card, 8 streams of 40 frames under
   mixed-tenant churn on padded shapes 8 and 4, then a second schedule
   over the same shapes: ``mbcodec_frame`` launches exactly one a padded
   lane-frame served plus the warm-ups', the second schedule builds and
   warms nothing, per-tenant windowed accuracy within 1e-5 of the
   tenant-grouped host scorer on the same outputs, padded lanes 0 bytes
   and never aggregated. It logs server seconds and lanes shared against
   dedicated, the largest score difference and QP flips between them,
   and the server seconds of each interval of a serialized run B, where a
   new tenant mix first meets its per-tenant batch sizes, beside a
   second, steady pass.
7. AccGrad kernel: ``accgrad_reduce`` at the label batch's shape (4
   frames of 384x640x3) against its plain version, relative error at most
   1e-5 of each macroblock's sum. Both are timed as above and, since the
   35 MB of inputs fit in the L2 cache, also with L2 flushed before each
   call; the flushed times go into the kernels line.
8. Training path at full size: 16 dashcam frames of 384x640 and the same
   detection FinalDNN. ``make_labels`` (batch 4) must make exactly 4
   ``accgrad_reduce`` launches with every op on the card, and its labels
   may differ from labels built from the same gradients through the plain
   reduction only where the normalised AccGrad lies within 1e-5 of the
   threshold. ``train_accmodel`` (15 epochs, width 16) must end below its
   first epoch's loss; ``train_accmodel_e2e`` runs the same, and both
   trainers' label and train times are printed (Table 2), after one
   untimed epoch of each on one batch has warmed the kernels. Last,
   ``train_final_dnn`` (detection, 1000 steps, width 32, no cache, under
   ``torch.use_deterministic_algorithms``) must lower the detection loss
   on a held batch; 9 drives this detector.
9. Baselines path: the same 30 frames through ``StreamingEngine.run``
   for uniform QP 38, DDS, EAAR, Reducto, Vigil, SiEVE, Reducto+AccMPEG
   and the rate-controlled AccMPEG (an lte trace, budget 0.2 s), each
   under exact, pallas, fused and fused_exact, with the detector trained
   in 8 as the server, Vigil's camera and SiEVE's model. Reducto's and
   SiEVE's thresholds are the first chunk's median change feature and
   presence delta, so that frames are both kept and dropped. Each audited
   run must make exactly its kernel launches (one chunk kernel a chunk
   plus the warm-up's under the fused backends for every RoI policy; one
   frame kernel a sent frame plus the warm-up's 10 under pallas, the kept
   frames for Reducto+AccMPEG; none for uniform, Reducto and SiEVE, which
   encode with the exact scan) with every op on the card. Per chunk,
   fused_exact's and pallas's bytes must be within rtol 1e-3 of exact's
   for DDS, Vigil and Reducto+AccMPEG, and EAAR's first chunk; DDS's
   ``extra_rtt_s`` must be the RTT. Knobs set and applied
   (``knob_array``, ``_controlled_prep``) must not synchronise (sync
   debug mode "error"). Vigil's masks must be neither all empty nor all
   full. It logs each RoI encode's high-QP share, the
   controller's knob path and every run's per-chunk encode and overhead
   times from a second, unaudited run.
10. LM kernels: ``decode_attn`` at the smollm decode path's shape (B=16,
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
11. LM serving at full width, random bf16 weights from a seeded generator:
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
12. Prints one JSON line of the rows at shapes or types the paths do not
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
import os
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
# closed-loop fleet: the fleet's scenes and four more, 60 frames each (6
# intervals); make_workload's seed 15 at 2.5 arrivals an interval, at most
# 8 streams at once and 12 ids gives 8, 8, 2, 3, 4, 7 active streams:
# padded shapes 8, 8, 2, 8, 8, 8 (a leave shrinks the shape, a join grows
# it). The second schedule (initial ids, then (interval, joins, leaves))
# serves 2, 1, 6, 8, 5, 2 streams on shapes 2, 2, 8, 8, 8, 2.
CLOSED_SEEDS, CLOSED_FRAMES = range(300, 312), 60
CLOSED_WORKLOAD = dict(n_chunks=6, rate_per_chunk=2.5, seed=15,
                       max_concurrent=8, max_streams=12)
SECOND_SCHEDULE = ((0, 1), ((1, (), (1,)), (2, (2, 3, 4, 5, 6), ()),
                            (3, (9, 10), ()), (4, (), (0, 2, 9)),
                            (5, (), (3, 4, 5))))
# runs 1 and 2: a constant 40 Mb/s uplink. Run 3: the baselines' lte
# trace (seed 7, mean 4 Mb/s) for its first half second, then recovered
# CLOSED_RECOVERY times over: 8 streams' ~1 MB an interval misses the 0.2
# s budget on the slow start (and queues the next chunk), so the
# controller cuts its level twice; the recovered uplink carries the next
# chunks in a few ms, under the budget's headroom, and the controller
# raises its level again. Run 3's autoscaler keeps the buffer depth at
# CLOSED_DEPTH: the knobs of interval k answer interval k - depth - 1, so
# a depth the autoscaler deepened from measured occupancy (3 on a loaded
# host) would leave the raise past the last of the 6 intervals
CLOSED_BPS, CLOSED_BUDGET_S, SIM_ENCODE_S = 4e7, 0.2, 0.05
CLOSED_RECOVERY, CLOSED_DEPTH = 100.0, 2
# accuracy bounds of run 1: its card reduce against the host scorer on
# the same fused_exact outputs, pooled; against exact's outputs, pooled
# and per stream-chunk. Exact and the kernel part at round-half flips
# that move a block, and near-tie argmax pixels follow (7.7e-05 pooled and
# 2.5e-03 a stream-chunk at most on the H100); the bounds sit above them
CLOSED_ACC_GAP = 1e-5
CLOSED_EXACT_GAP, CLOSED_EXACT_CHUNK_GAP = 5e-4, 1e-2
# multi-tenant fleet (phase 6). Run A: benchmarks/multitenant.py's pair,
# 5 detection (dashcam) + 3 segmentation (surf) streams of 30 frames on
# one fleet, its uplink and sim_encode_s; the dedicated fleets take the
# uplink pro rata. Calibration: 16 surf frames. Run B: 4 segmentation
# (surf, ids 0-3) and 4 keypoint (driving, ids 4-7) streams of 40
# frames; the schedules (initial ids, then (interval, joins, leaves))
# serve, as (segmentation, keypoint) streams: 2/2, 4/4, 2/3, 1/3 on
# shapes 4, 8, 8, 4; then 0/4, 4/4, 4/0, 2/2 on shapes 4, 8, 4, 4 (a
# shape admitted once is reused by every count it fits within twice)
MT_DET_SEEDS, MT_SEG_SEEDS, MT_FRAMES = range(300, 305), range(800, 803), 30
MT_UPLINK_BPS, MT_CALIB_SEED, MT_CALIB_FRAMES = 2.5e6, 830, 16
MT_B_SEG_SEEDS, MT_B_KP_SEEDS, MT_B_FRAMES = (range(810, 814),
                                              range(820, 824), 40)
MT_B_SCHEDULES = (((0, 3, 4, 7), ((1, (1, 2, 5, 6), ()),
                                  (2, (), (1, 2, 5)), (3, (5,), (0, 6)))),
                  ((4, 5, 6, 7), ((1, (0, 1, 2, 3), ()),
                                  (2, (), (4, 5, 6, 7)),
                                  (3, (4, 5), (0, 1)))))
MT_ACC_GAP = 1e-5  # the card reduce against the host scorer, same outputs
BASELINES = ("uniform", "dds", "eaar", "reducto", "vigil", "sieve",
             "reducto_accmpeg", "accmpeg_controlled")
# the controlled run's trace (lte, mean 4 Mb/s) and delay budget: a chunk
# of ~140 KB takes ~0.3 s to stream at the mean rate, so 0.2 s is missed
# and the controller moves its knobs
TRACE_SEED, CONTROL_BUDGET_S = 7, 0.2
# training: 2 dashcam scenes of 8 frames, labelled 4 frames per batch with
# the reference trainer's defaults (qp 30 / 40, label_alpha 0.1)
TRAIN_SEED, TRAIN_SCENES, TRAIN_SCENE_FRAMES, HELD_SEED = 200, 2, 8, 210
# 1000 detector steps: after the reference's default 400 the detector
# finds no box on the single-stream scene at any decode threshold of the
# baselines (0.15 to 0.3), and every RoI mask of phase 8 is empty. The
# training wanders (batches of 4, a constant rate), and the convolutions'
# nondeterministic backward on the card made each run's detector another
# one: some found no box on the scene and left Vigil's masks empty. So
# the steps run with deterministic algorithms: one detector in every run
# on a given card and software stack
LABEL_BATCH, LABEL_ALPHA, TRAIN_EPOCHS, DNN_STEPS = 4, 0.1, 15, 1000
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


def _finish_recorder(eng, records):
    """Wrap ``eng._finish`` (and, in windowed runs, the live aggregator's
    ``observe``): after each chunk's host stage, record its interval, its
    active ids, every lane's bytes and its device-reduced accuracies; the
    aggregator records the ids it was handed."""
    finish = eng._finish

    def wrapped(p, *args, **kw):
        agg = eng._agg
        if agg is not None and "observe" not in vars(agg):
            observe = agg.observe

            def seen(ci, sids, *rest):
                records["observed"].append((ci, [int(x) for x in sids]))
                return observe(ci, sids, *rest)

            agg.observe = seen
        finish(p, *args, **kw)
        acc = p.get("acc_dev")
        records["chunks"].append((p["ci"], list(p["ids"]),
                                  p["pbytes"].numpy().sum(axis=1),
                                  None if acc is None else acc.numpy()))

    eng._finish = wrapped
    return records


def _strict_sync(fn):
    """``fn`` run under sync debug mode "error": it fails if the call
    synchronises with the card."""
    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return strict


def _concurrency(initial, events, n_int):
    from repro_torch.control import apply_churn

    active, counts = list(initial), []
    for ci in range(n_int):
        active = apply_churn(active, events, ci)
        counts.append(len(active))
    return counts


def expected_launches(counts, decisions, overlap, depth, warmed=(),
                      per_step=lambda n_padded: 1):
    """The loop's rule for the scores kernel: one launch a served
    interval, plus the warm-up of each (padded shape, overlap) first met:
    one step, and one timed hot step when overlapped. Admission is
    replayed through a fresh ``FleetAutoscaler`` (the engines' default
    admission), and overlap follows the decisions as ``serve_loop``
    adopts them (one decision a served interval). ``per_step`` gives a
    camera step's launches at a padded shape (the frame kernel's: one a
    lane-frame)."""
    from repro_torch.control import FleetAutoscaler

    scaler, warmed, n, k = FleetAutoscaler(), set(warmed), 0, 0
    for c in counts:
        plan = scaler.admit(c)
        if not plan.n_padded:
            continue
        if (plan.n_padded, overlap) not in warmed:
            warmed.add((plan.n_padded, overlap))
            n += (2 if overlap else 1) * per_step(plan.n_padded)
        n += per_step(plan.n_padded)
        if decisions:
            d, k = decisions[k], k + 1
            if d.batch_depth != (depth if overlap else 1):
                overlap, depth = d.batch_depth >= 2, d.batch_depth
    return n, warmed


def closed_loop_phase(am):
    """``MultiStreamEngine.serve_loop`` under churn at full size: a seeded
    ``make_workload`` over 12 dashcam streams of 60 frames of 384x640,
    with a segmentation FinalDNN of width 32 as server (so the accuracy
    reduce runs on the card) and the fleet's AccModel."""
    from repro_torch import obs
    from repro_torch.control import (ChurnEvent, FleetAutoscaler,
                                     NetworkTrace, RateController,
                                     constant_trace, lte_trace,
                                     make_workload)
    from repro_torch.core.quality import QualityConfig
    from repro_torch.data.video import make_scene
    from repro_torch.engine import EngineConfig, MultiStreamEngine
    from repro_torch.engine import multistream
    from repro_torch.kernels.mbcodec.kernel import (LAUNCHES,
                                                    scores_kernel_name)
    from repro_torch.obs import CompileCounter
    from repro_torch.vision.dnn import FinalDNN

    t_phase = time.perf_counter()
    frames = torch.from_numpy(np.stack([
        make_scene("dashcam", seed=s, T=CLOSED_FRAMES, H=HEIGHT,
                   W=WIDTH_PX).frames for s in CLOSED_SEEDS])).cuda()
    n_int = CLOSED_FRAMES // CHUNK_FRAMES
    server = FinalDNN("segmentation", width=32, device="cuda",
                      generator=torch.Generator().manual_seed(1))
    alpha = median_alpha(am, frames[0, :1])
    qcfg = QualityConfig(alpha=alpha, gamma=2)
    wl = make_workload(**CLOSED_WORKLOAD)
    counts = wl.concurrency()
    initial2, spec = SECOND_SCHEDULE
    events2 = [ChurnEvent(c, join=j, leave=lv) for c, j, lv in spec]
    counts2 = _concurrency(initial2, events2, n_int)
    agg_cfg = wl.aggregate_config(window=2)
    lte = lte_trace(seed=TRACE_SEED)
    lte = NetworkTrace(np.concatenate([lte.bw_bps[:1], lte.bw_bps[1:]
                                       * CLOSED_RECOVERY]), lte.dt_s,
                       rtt_s=lte.rtt_s, genre="lte, recovering",
                       seed=TRACE_SEED)
    log(f"closed-loop fleet: {len(CLOSED_SEEDS)} dashcam streams (seeds "
        f"{CLOSED_SEEDS.start}-{CLOSED_SEEDS.stop - 1}) of {CLOSED_FRAMES} "
        f"frames of {HEIGHT}x{WIDTH_PX}, segmentation FinalDNN width 32, "
        f"the fleet's AccModel, alpha {alpha:.6f}; workload "
        f"{CLOSED_WORKLOAD}: active {counts}, events "
        f"{[(e.chunk, e.join, e.leave) for e in wl.events]}, tiers "
        f"{wl.tier_fractions()}; second schedule active {counts2}")
    if max(counts) != 8 or wl.n_streams != len(CLOSED_SEEDS):
        raise AssertionError("the workload is not the one described")

    def engine(impl, detail, **kw):
        return MultiStreamEngine(server, am, config=EngineConfig(
            qcfg=qcfg, impl=impl, detail=detail, aggregate=agg_cfg, **kw))

    def served(res):
        return len(res.served_cis)

    fixed = dict(trace=constant_trace(CLOSED_BPS, rtt_s=0.02),
                 sim_encode_s=SIM_ENCODE_S)
    run_kw = dict(initial=wl.initial, events=wl.events)
    LAUNCHES.clear()  # every count to 0 just before the path
    off_card, rec = set(), {}

    # run 1: fused_exact, windowed, no controller
    eng1 = engine("fused_exact", "windowed", **fixed)
    rec[1] = _finish_recorder(eng1, {"chunks": [], "observed": []})
    lane_flags = multistream._lane_flags
    multistream._lane_flags = _strict_sync(lane_flags)
    try:
        res1, moved1, off = audited(lambda: eng1.serve_loop(
            frames, rescale=False, **run_kw))
        off_card |= off
        want1, _ = expected_launches(counts, None, True, 2)
        got1 = moved1.get(scores_kernel_name(True), 0)
        log(f"  run 1 (fused_exact, windowed): launches {moved1}; expected "
            f"{want1} = {served(res1)} served intervals + 2 x "
            f"{len(res1.shapes)} new padded shapes {res1.shapes}")
        if moved1 != {scores_kernel_name(True): want1}:
            raise AssertionError(f"run 1 launched {moved1}, expected "
                                 f"{want1}")

        # run 3: fused, lte trace, controller, autoscaler, obs on
        ctrl = RateController(delay_budget_s=CLOSED_BUDGET_S)
        ctrl.knob_array = _strict_sync(ctrl.knob_array)
        # depth 2 keeps the loop overlapped, so each padded shape is
        # warmed once and run 4 can reuse every one of them, and fixes
        # the controller's feedback lag
        eng3 = engine("fused", "windowed", trace=lte, controller=ctrl,
                      autoscaler=FleetAutoscaler(min_depth=CLOSED_DEPTH,
                                                 max_depth=CLOSED_DEPTH))
        rec[3] = _finish_recorder(eng3, {"chunks": [], "observed": []})
        tracer, reg = obs.enable(host=0)
        try:
            res3, moved3, off = audited(lambda: eng3.serve_loop(
                frames, **run_kw))
        finally:
            obs.disable()
        off_card |= off
        want3, warmed = expected_launches(counts, res3.decisions, True, 2)
        log(f"  run 3 (fused, lte, controller, autoscaler, windowed, obs "
            f"on): launches {moved3}; expected {want3} by the loop's rule "
            f"over the decisions")
        if moved3 != {scores_kernel_name(False): want3}:
            raise AssertionError(f"run 3 launched {moved3}, expected "
                                 f"{want3}")

        # run 4: a second schedule through run 3's engine, same shapes
        counter = CompileCounter.for_engine(eng3)
        want4, warmed4 = expected_launches(counts2, None, eng3.overlap,
                                           eng3.depth, warmed)
        if warmed4 != warmed:
            raise AssertionError("the second schedule meets a new shape")
        res4, moved4, off = audited(lambda: eng3.serve_loop(
            frames, initial=initial2, events=events2, rescale=False))
        off_card |= off
        log(f"  run 4 (second schedule, run 3's engine): launches {moved4}"
            f", expected {want4} = one a served interval; shapes "
            f"{res4.shapes}; builds {counter.sizes()}, growth "
            f"{counter.growth()}")
        if moved4 != {scores_kernel_name(False): served(res4)} or \
                want4 != served(res4):
            raise AssertionError(f"run 4 launched {moved4}")
        counter.assert_no_recompiles("the second schedule")
    finally:
        multistream._lane_flags = lane_flags
    launches = dict(LAUNCHES)  # read just after the path
    if off_card:
        raise AssertionError(f"ops off the card: {sorted(off_card)}")
    log("  every op of runs 1, 3 and 4 ran on cuda (transfers aside); the "
        "lane masks and knob tensors were set under sync debug mode "
        "'error'")

    # padding: padded lanes carry 0 bytes and never reach the aggregator
    for run in (1, 3):
        chunks, observed = rec[run]["chunks"], rec[run]["observed"]
        if any(float(np.abs(b[len(ids):]).sum()) != 0.0
               for _, ids, b, _ in chunks):
            raise AssertionError(f"run {run}: a padded lane sent bytes")
        if observed != [(ci, ids) for ci, ids, _, _ in chunks if ids]:
            raise AssertionError(f"run {run}: the aggregator saw other "
                                 f"lanes than the active ones")
    log(f"  padded lanes: exactly 0 bytes in "
        f"{sum(len(b) - len(i) for _, i, b, _ in rec[1]['chunks'])} "
        f"padded lane-chunks of run 1; the aggregator saw only active ids")

    # run 2: exact, per-chunk results scored on the host. Its bytes hold
    # run 1's; its accuracies differ where a round-half flip between the
    # exact scan and the kernel moves a block and a near-tie argmax
    # follows, so the reduce is held against the same host scorer on run
    # 1's own outputs: fused_exact again (the kernel is deterministic),
    # per-chunk results scored on the host
    res2 = engine("exact", "chunks", **fixed).serve_loop(
        frames, rescale=False, **run_kw)
    res2b = engine("fused_exact", "chunks", **fixed).serve_loop(
        frames, rescale=False, **run_kw)

    def per_chunk(res):
        return {(sid, c.ci): c for sid, r in zip(res.stream_ids, res.streams)
                for c in r.chunks}

    ref, same = per_chunk(res2), per_chunk(res2b)
    b1 = {(sid, ci): float(b[i]) for ci, ids, b, _ in rec[1]["chunks"]
          for i, sid in enumerate(ids)}
    a1 = {(sid, ci): float(a[i]) for ci, ids, _, a in rec[1]["chunks"]
          for i, sid in enumerate(ids)}
    if not set(b1) == set(ref) == set(same) or len(ref) != sum(counts):
        raise AssertionError("runs 1 and 2 served other stream-chunks")
    rel = max(abs(b1[k] - ref[k].bytes) / ref[k].bytes for k in ref)
    gap = max(abs(a1[k] - ref[k].accuracy) for k in ref)
    if any(b1[k] != same[k].bytes for k in same):
        raise AssertionError("fused_exact runs differ in bytes")
    gap_same = max(abs(a1[k] - same[k].accuracy) for k in same)
    mean2 = float(np.mean([c.accuracy for c in ref.values()]))
    mean_same = float(np.mean([c.accuracy for c in same.values()]))
    pooled = abs(res1.aggregate.accuracy - mean_same)
    pooled2 = abs(res1.aggregate.accuracy - mean2)
    log(f"  run 1 vs run 2 (exact, host-scored) over {len(ref)} "
        f"stream-chunks: bytes within {rel:.3e}; accuracy gap max "
        f"{gap:.3e} per stream-chunk (bound {CLOSED_EXACT_CHUNK_GAP}), "
        f"windowed mean {res1.aggregate.accuracy:.9f} vs {mean2:.9f} "
        f"(gap {pooled2:.3e}, bound {CLOSED_EXACT_GAP})")
    log(f"  run 1's card reduce vs the host scorer on the same fused_exact "
        f"outputs: windowed mean accuracy {res1.aggregate.accuracy:.9f} vs "
        f"{mean_same:.9f} (gap {pooled:.3e}, bound {CLOSED_ACC_GAP}); per "
        f"stream-chunk gap max {gap_same:.3e}; bytes identical")
    if rel > 1e-3:
        raise AssertionError("run 1 bytes differ from exact's")
    if gap > CLOSED_EXACT_CHUNK_GAP or pooled2 > CLOSED_EXACT_GAP:
        raise AssertionError("run 1 accuracy differs from exact's")
    if pooled > CLOSED_ACC_GAP:
        raise AssertionError("the card reduce disagrees with the host")

    # run 3's sanity and its telemetry against FleetTiming
    agg3 = res3.aggregate
    att = agg3.attainment()
    finite = [agg3.accuracy, agg3.sum_bytes, agg3.sum_delay,
              agg3.max_delay, agg3.p90_delay]
    qp_path = [round(k.qp_hi, 4) for k, _ in ctrl.history]
    moves = sum(a != b for a, b in zip(qp_path, qp_path[1:]))
    log(f"  run 3: shapes {res3.shapes}, decisions "
        f"{[(d.batch_depth, d.reason) for d in res3.decisions]}; knob path "
        f"qp_hi {qp_path} ({moves} moves); attainment {att}; "
        f"{json.dumps(res3.summary())}")
    if not all(np.isfinite(finite)) or agg3.n != sum(counts) or not all(
            0.0 <= v <= 1.0 for v in att.values() if v == v):
        raise AssertionError(f"run 3: malformed result {finite} {att}")
    richer = sum(b < a for a, b in zip(qp_path, qp_path[1:]))
    if moves < 2 or not richer or richer == moves:
        raise AssertionError(f"run 3: the controller moved qp_hi {moves} "
                             f"times, {richer} of them down: it should "
                             f"move it at least twice, both ways")
    t3 = res3.timing
    for stage, series in (("camera", t3.camera_s), ("server", t3.server_s),
                          ("host", t3.host_s)):
        got = reg.get("stage_seconds_total", stage=stage).value
        if abs(got - float(np.sum(series))) > 1e-9 * max(got, 1e-9):
            raise AssertionError(f"obs {stage} seconds {got} != timing")
    if reg.get("chunks_served_total").value != agg3.n or abs(
            reg.get("wire_bytes_total").value - agg3.sum_bytes) > \
            1e-9 * agg3.sum_bytes:
        raise AssertionError("obs counters disagree with the aggregate")
    actions = {a: reg.get("controller_decisions_total", action=a)
               for a in ("increase", "decrease", "hold")}
    made = {a: c.value for a, c in actions.items() if c is not None}
    log(f"  run 3 telemetry: stage counters equal FleetTiming's sums; "
        f"{len(tracer.events)} trace events; controller decisions {made}")
    if not made.get("increase") or not made.get("decrease"):
        raise AssertionError("run 3: the controller did not both raise and "
                             "cut its level")

    # timings from runs outside the audit (whose per-op hook would
    # dominate the host clock): windowed against chunks, then run 3 again
    timed = {"windowed": engine("fused_exact", "windowed", **fixed),
             "chunks": engine("fused_exact", "chunks", **fixed)}
    for name, eng in timed.items():
        eng.serve_loop(frames, rescale=False, **run_kw)  # warm every shape
        r = eng.serve_loop(frames, rescale=False, **run_kw)
        t = r.timing
        busy = (sum(t.camera_s) + sum(t.server_s)) / t.wall_s
        log(f"  {name} (fused_exact, {CARD}): host stage "
            f"{1e3 * float(np.mean(t.host_s)):.4f} ms an interval, "
            f"{json.dumps(t.summary())}, device-stage share of wall "
            f"{busy:.4f}")
    eng = engine("fused", "windowed", trace=lte,
                 controller=RateController(delay_budget_s=CLOSED_BUDGET_S),
                 autoscaler=FleetAutoscaler(min_depth=CLOSED_DEPTH,
                                            max_depth=CLOSED_DEPTH))
    t = eng.serve_loop(frames, **run_kw).timing
    busy = (sum(t.camera_s) + sum(t.server_s)) / t.wall_s
    log(f"  run 3 unaudited ({CARD}): {json.dumps(t.summary())}, "
        f"device-stage share {busy:.4f}")
    log(f"  closed-loop phase: {time.perf_counter() - t_phase:.2f} s")
    del frames
    torch.cuda.empty_cache()
    return launches


def _unaudited(fn):
    """``fn`` run outside any dispatch mode (the device audit): for the
    AccModel's seeded initial weights, which every module of the port
    draws on the host from a CPU generator and then moves to the card."""
    from torch.utils._python_dispatch import _disable_current_modes

    def run(*args, **kw):
        with _disable_current_modes():
            return fn(*args, **kw)
    return run


def _pooled(res, tenant_of):
    """Per-tenant mean accuracy pooled over stream-chunks, and the
    per-chunk {(stream, ci): chunk} map, of a per-chunk result."""
    chunks = {(sid, c.ci): c for sid, r in zip(res.stream_ids, res.streams)
              for c in r.chunks}
    n_t = max(tenant_of.values()) + 1
    pooled = tuple(float(np.mean([c.accuracy for (sid, _), c in
                                  chunks.items() if tenant_of[sid] == t]))
                   for t in range(n_t))
    return pooled, chunks


def multitenant_phase(rows, dnn, am):
    """Multi-tenant fleet serving at full size: ``calibrate_tenant`` with
    its cache, run A (one quality config, the scores kernel, against
    dedicated fleets) and run B (per-tenant QP ladders, the frame kernel,
    windowed with the tenant reduce on the card, mixed-tenant churn)."""
    import tempfile

    from repro_torch.control import (ChurnEvent, FleetAutoscaler, apply_churn,
                                     pad_streams)
    from repro_torch.core import training
    from repro_torch.core.pipeline import NetworkConfig
    from repro_torch.core.quality import QualityConfig, dilate_scores
    from repro_torch.data.video import make_scene
    from repro_torch.engine import EngineConfig, MultiStreamEngine
    from repro_torch.engine import multistream
    from repro_torch.kernels.accgrad_reduce.kernel import \
        LAUNCHES as ACC_LAUNCHES
    from repro_torch.kernels.mbcodec.kernel import (LAUNCHES,
                                                    scores_kernel_name)
    from repro_torch.obs import CompileCounter
    from repro_torch.serve.tenants import TenantSpec, calibrate_tenant
    from repro_torch.vision.dnn import FinalDNN

    t_phase = time.perf_counter()

    def scenes(genre, seeds, T):
        return [make_scene(genre, seed=s, T=T, H=HEIGHT, W=WIDTH_PX).frames
                for s in seeds]

    seg_dnn = FinalDNN("segmentation", width=32, device="cuda",
                       generator=torch.Generator().manual_seed(1))
    kp_dnn = FinalDNN("keypoint", width=32, device="cuda",
                      generator=torch.Generator().manual_seed(2))
    kp_am = training.accmodel_init(3, 16, "cuda")
    calib = make_scene("surf", seed=MT_CALIB_SEED, T=MT_CALIB_FRAMES,
                       H=HEIGHT, W=WIDTH_PX).frames
    n_det = len(MT_DET_SEEDS)
    frames_a = torch.from_numpy(np.stack(
        scenes("dashcam", MT_DET_SEEDS, MT_FRAMES)
        + scenes("surf", MT_SEG_SEEDS, MT_FRAMES))).cuda()
    n_a = frames_a.shape[0]
    frames_b = torch.from_numpy(np.stack(
        scenes("surf", MT_B_SEG_SEEDS, MT_B_FRAMES)
        + scenes("driving", MT_B_KP_SEEDS, MT_B_FRAMES))).cuda()
    alpha = median_alpha(am, frames_a[0, :1])
    qcfg = QualityConfig(alpha=alpha, gamma=2)
    log(f"multi-tenant fleet: server DNNs width 32, AccModels width 16, "
        f"{HEIGHT}x{WIDTH_PX}, alpha {alpha:.6f}, gamma 2")

    # -- calibration: onboard the segmentation server, twice ---------------
    init = training.accmodel_init
    training.accmodel_init = _unaudited(init)
    try:
        with tempfile.TemporaryDirectory() as cache:
            ACC_LAUNCHES.clear()  # every count to 0 just before the path
            t0 = time.perf_counter()
            seg_spec, moved, off = audited(lambda: calibrate_tenant(
                "segmentation", seg_dnn, calib, qcfg=qcfg, cache_dir=cache))
            first_s = time.perf_counter() - t0
            calib_launches = ACC_LAUNCHES.get("accgrad_reduce", 0)
            t0 = time.perf_counter()
            again, moved2, off2 = audited(lambda: calibrate_tenant(
                "segmentation", seg_dnn, calib, qcfg=qcfg, cache_dir=cache))
            again_s = time.perf_counter() - t0
            cached = sorted(os.listdir(cache))
    finally:
        training.accmodel_init = init
    log(f"  calibrate_tenant on {MT_CALIB_FRAMES} surf frames: first call "
        f"{first_s:.3f} s, launches {moved}; second call {again_s:.3f} s, "
        f"launches {moved2}; cache {cached}")
    if moved != {"accgrad_reduce": MT_CALIB_FRAMES // LABEL_BATCH} or \
            calib_launches != MT_CALIB_FRAMES // LABEL_BATCH or moved2:
        raise AssertionError("calibrate_tenant: wrong launches")
    if off | off2:
        raise AssertionError(f"ops off the card: {sorted(off | off2)}")
    sd1, sd2 = seg_spec.accmodel.state_dict(), again.accmodel.state_dict()
    if len(cached) != 1 or not all(torch.equal(sd1[k], sd2[k])
                                   for k in sd1):
        raise AssertionError("the cached AccModel differs from the trained")
    log("  every op of both calls on cuda (transfers and the AccModel's "
        "seeded host-drawn initial weights aside); the restore equals the "
        "trained AccModel bit for bit")

    # -- run A: one quality config, the scores kernel ------------------------
    det_spec = TenantSpec("detection", dnn, am, qcfg=qcfg)
    tenant_of = {i: int(i >= n_det) for i in range(n_a)}
    fixed = dict(impl="fused_exact", sim_encode_s=SIM_ENCODE_S)

    def shared_engine():
        return MultiStreamEngine(config=EngineConfig(
            net=NetworkConfig.shared(MT_UPLINK_BPS, n_a),
            autoscaler=FleetAutoscaler(), tenants=(det_spec, seg_spec),
            tenant_of=tenant_of, **fixed))

    def dedicated(spec, n):
        return MultiStreamEngine(spec.dnn, spec.accmodel, config=EngineConfig(
            qcfg=qcfg, net=NetworkConfig.shared(MT_UPLINK_BPS * n / n_a, n),
            autoscaler=FleetAutoscaler(), **fixed))

    name_a = scores_kernel_name(True)
    lane_flags, tenant_lanes = multistream._lane_flags, \
        multistream.TenantLanes
    multistream._lane_flags = _strict_sync(lane_flags)
    multistream.TenantLanes = _strict_sync(tenant_lanes)
    try:
        LAUNCHES.clear()  # every count to 0 just before the path
        eng_a = shared_engine()
        res_a, moved_a, off = audited(lambda: eng_a.serve_loop(frames_a))
        want_a, _ = expected_launches([n_a] * (MT_FRAMES // CHUNK_FRAMES),
                                      res_a.decisions, True, 2)
        launches_a = LAUNCHES.get(name_a, 0)
    finally:
        multistream._lane_flags = lane_flags
        multistream.TenantLanes = tenant_lanes
    log(f"  run A (shared, fused_exact): launches {moved_a}, expected "
        f"{want_a} by the loop's rule; shapes {res_a.shapes}; decisions "
        f"{[(d.batch_depth, d.tenant_share) for d in res_a.decisions]}")
    if moved_a != {name_a: want_a} or launches_a != want_a:
        raise AssertionError(f"run A launched {moved_a}")
    if off:
        raise AssertionError(f"ops off the card: {sorted(off)}")
    share = (n_det / n_a, 1 - n_det / n_a)
    if not res_a.decisions or any(d.tenant_share != share
                                  for d in res_a.decisions):
        raise AssertionError("run A: tenant_share is not 5/8, 3/8")
    ded = [dedicated(det_spec, n_det), dedicated(seg_spec, n_a - n_det)]
    res_d = [ded[0].serve_loop(frames_a[:n_det]),
             ded[1].serve_loop(frames_a[n_det:])]
    pooled_a, ch_a = _pooled(res_a, tenant_of)
    ch_d = {}
    for t, r in enumerate(res_d):
        off_id = 0 if t == 0 else n_det
        ch_d.update({(sid + off_id, c.ci): c
                     for sid, r_s in zip(r.stream_ids, r.streams)
                     for c in r_s.chunks})
    pooled_d = (float(np.mean([c.accuracy for (sid, _), c in ch_d.items()
                               if sid < n_det])),
                float(np.mean([c.accuracy for (sid, _), c in ch_d.items()
                               if sid >= n_det])))
    if set(ch_a) != set(ch_d):
        raise AssertionError("run A and the dedicated fleets served other "
                             "stream-chunks")
    gap = max(abs(ch_a[k].accuracy - ch_d[k].accuracy) for k in ch_a)
    rel = max(abs(ch_a[k].bytes - ch_d[k].bytes) / ch_d[k].bytes
              for k in ch_a)
    pooled_gap = max(abs(a - b) for a, b in zip(pooled_a, pooled_d))
    log(f"  run A vs dedicated fleets: per-tenant accuracy {pooled_a} vs "
        f"{pooled_d} (gap {pooled_gap:.3e}, bound {CLOSED_EXACT_GAP}); per "
        f"stream-chunk gap max {gap:.3e} (bound {CLOSED_EXACT_CHUNK_GAP}); "
        f"bytes within {rel:.3e}")
    if pooled_gap > CLOSED_EXACT_GAP or gap > CLOSED_EXACT_CHUNK_GAP \
            or rel > 1e-3:
        raise AssertionError("run A differs from the dedicated fleets")

    # scores and QP maps: the shared camera step against the dedicated
    # ones, each at its fleet's padded shape
    def scores(engine, batch, n_padded, *lanes):
        n = batch.shape[0]
        active = torch.arange(n_padded, device=batch.device) < n
        step = engine._steps[(False, True)][0]
        return step(pad_streams(batch, n_padded), *lanes, active)[2][:n]

    lanes = eng_a._tenant_lane_ids(range(n_a), res_a.shapes[0])
    score_gap, flips, blocks = 0.0, 0, 0
    for s in range(0, MT_FRAMES, CHUNK_FRAMES):
        batch = frames_a[:, s:s + CHUNK_FRAMES]
        got = scores(eng_a, batch, res_a.shapes[0], lanes)
        want = torch.cat([scores(ded[0], batch[:n_det], res_d[0].shapes[0]),
                          scores(ded[1], batch[n_det:], res_d[1].shapes[0])])
        score_gap = max(score_gap, float((got - want).abs().max()))
        flips += int(((dilate_scores(got, 2) >= alpha)
                      != (dilate_scores(want, 2) >= alpha)).sum())
        blocks += got.numel()
    log(f"  run A scores, shared vs dedicated camera steps: max abs "
        f"difference {score_gap:.3e}; QP flips {flips} of {blocks} blocks")

    # server seconds and lanes, from runs outside the audit (each warm)
    shared_t = shared_engine()
    shared_t.serve_loop(frames_a)
    t_sh = shared_t.serve_loop(frames_a).timing
    t_de = [e.serve_loop(f).timing for e, f in
            ((ded[0], frames_a[:n_det]), (ded[1], frames_a[n_det:]))]
    srv_sh = float(np.sum(t_sh.server_s))
    srv_de = sum(float(np.sum(t.server_s)) for t in t_de)
    log(f"  run A server seconds ({CARD}): shared {srv_sh:.6f} s on "
        f"{sum(res_a.shapes)} lanes, dedicated {srv_de:.6f} s on "
        f"{sum(r.shapes[0] for r in res_d)} lanes "
        f"({srv_de / srv_sh:.3f}x); shared stages "
        f"{json.dumps(t_sh.summary())}")

    # -- run B: per-tenant QP ladders, the frame kernel, windowed ----------
    n_seg_b = len(MT_B_SEG_SEEDS)
    n_b = frames_b.shape[0]
    tenants_b = (TenantSpec("segmentation", seg_dnn, seg_spec.accmodel,
                            qcfg=QualityConfig(alpha=alpha, gamma=2,
                                               qp_hi=30, qp_lo=40)),
                 TenantSpec("keypoint", kp_dnn, kp_am,
                            qcfg=QualityConfig(alpha=alpha, gamma=2,
                                               qp_hi=30, qp_lo=51)))
    tenant_of_b = {i: int(i >= n_seg_b) for i in range(n_b)}
    n_int_b = MT_B_FRAMES // CHUNK_FRAMES
    scheds = [(init_ids, [ChurnEvent(c, join=j, leave=lv)
                          for c, j, lv in spec])
              for init_ids, spec in MT_B_SCHEDULES]
    counts_b = [_concurrency(i, ev, n_int_b) for i, ev in scheds]

    def engine_b(detail, **kw):
        return MultiStreamEngine(config=EngineConfig(
            impl="pallas", detail=detail, sim_encode_s=SIM_ENCODE_S,
            tenants=tenants_b, tenant_of=tenant_of_b, **kw))

    per_step = lambda n_padded: n_padded * CHUNK_FRAMES  # noqa: E731
    eng_b = engine_b("windowed")
    rec = _finish_recorder(eng_b, {"chunks": [], "observed": []})
    multistream._lane_flags = _strict_sync(lane_flags)
    multistream.TenantLanes = _strict_sync(tenant_lanes)
    try:
        LAUNCHES.clear()  # every count to 0 just before the path
        res_b, moved_b, off = audited(lambda: eng_b.serve_loop(
            frames_b, initial=scheds[0][0], events=scheds[0][1],
            rescale=False))
        want_b, warmed = expected_launches(counts_b[0], None, True, 2,
                                           per_step=per_step)
        counter = CompileCounter.for_engine(eng_b)
        res_b2, moved_b2, off2 = audited(lambda: eng_b.serve_loop(
            frames_b, initial=scheds[1][0], events=scheds[1][1],
            rescale=False))
        want_b2, warmed2 = expected_launches(counts_b[1], None, True, 2,
                                             warmed, per_step=per_step)
        launches_b = LAUNCHES.get("mbcodec_frame", 0)
    finally:
        multistream._lane_flags = lane_flags
        multistream.TenantLanes = tenant_lanes
    log(f"  run B (pallas, windowed, tenant reduce on the card): active "
        f"{counts_b[0]} on shapes {res_b.shapes}, launches {moved_b}, "
        f"expected {want_b}; second schedule active {counts_b[1]}, "
        f"launches {moved_b2}, expected {want_b2}; builds "
        f"{counter.sizes()}, growth {counter.growth()}")
    if moved_b != {"mbcodec_frame": want_b} or \
            moved_b2 != {"mbcodec_frame": want_b2} or warmed2 != warmed \
            or launches_b != want_b + want_b2:
        raise AssertionError("run B launched other than its rule")
    counter.assert_no_recompiles("run B's second schedule")
    if off | off2:
        raise AssertionError(f"ops off the card: {sorted(off | off2)}")
    if eng_b._acc_step is None:
        raise AssertionError("run B did not reduce accuracy on the card")
    chunks, observed = rec["chunks"], rec["observed"]
    if any(float(np.abs(b[len(ids):]).sum()) != 0.0
           for _, ids, b, _ in chunks):
        raise AssertionError("run B: a padded lane sent bytes")
    if observed != [(ci, ids) for ci, ids, _, _ in chunks if ids]:
        raise AssertionError("run B: the aggregator saw other lanes than "
                             "the active ones")
    host_b = engine_b("chunks").serve_loop(
        frames_b, initial=scheds[0][0], events=scheds[0][1], rescale=False)
    pooled_b, ch_b = _pooled(host_b, tenant_of_b)
    card_b = res_b.aggregate.accuracy_by_tenant()
    gap_b = max(abs(a - b) for a, b in zip(card_b, pooled_b))
    log(f"  run B per-tenant windowed accuracy (card reduce) {card_b} vs "
        f"the tenant-grouped host scorer on the same outputs {pooled_b} "
        f"(gap {gap_b:.3e}, bound {MT_ACC_GAP}); "
        f"{sum(len(b) - len(i) for _, i, b, _ in chunks)} padded "
        f"lane-chunks sent 0 bytes and were never aggregated")
    if gap_b > MT_ACC_GAP or res_b.aggregate.n != sum(counts_b[0]) or \
            len(ch_b) != sum(counts_b[0]):
        raise AssertionError("run B's card reduce disagrees with the host")

    # per-interval server seconds, serialized: where a tenant mix first
    # meets its per-tenant batch sizes, beside a second, steady pass
    timed = engine_b("windowed", overlap=False)
    passes = [timed.serve_loop(frames_b, initial=scheds[0][0],
                               events=scheds[0][1], rescale=False).timing
              for _ in range(2)]
    active = list(scheds[0][0])
    for ci in range(n_int_b):
        active = apply_churn(active, scheds[0][1], ci)
        n_seg = sum(1 for sid in active if not tenant_of_b[sid])
        log(f"    run B interval {ci} ({n_seg} segmentation + "
            f"{len(active) - n_seg} keypoint streams; {CARD}): server "
            f"{passes[0].server_s[ci] * 1e3:.4f} ms, steady "
            f"{passes[1].server_s[ci] * 1e3:.4f} ms")
    log(f"  multi-tenant phase: {time.perf_counter() - t_phase:.2f} s")
    del frames_a, frames_b
    torch.cuda.empty_cache()
    for name, n in ((name_a, launches_a), ("mbcodec_frame", launches_b),
                    ("accgrad_reduce", calib_launches)):
        rows[name]["launches"] = rows[name].get("launches", 0) + n
    return {name_a: launches_a, "mbcodec_frame": launches_b,
            "accgrad_reduce": calib_launches}


def _recording_encoder(shares):
    """``engine.jit_encode`` that also records, for each RoI encode, the
    share of macroblocks at its map's lowest QP (the high-quality level)
    and that QP: 1.0 means one QP for the whole map."""
    from repro_torch.codec.codec import CHUNK_ENCODERS

    def resolve(impl):
        encode = CHUNK_ENCODERS.resolve(impl)

        def run(frames, qp_maps):
            lowest = qp_maps.min()
            shares.append((round(float((qp_maps == lowest).float().mean()),
                                 4), round(float(lowest), 2)))
            return encode(frames, qp_maps)
        return run
    return resolve


def baselines_phase(scene_frames, server, am):
    """The paper's comparison set through ``StreamingEngine.run`` at full
    size: uniform, DDS, EAAR, Reducto, Vigil, SiEVE, Reducto+AccMPEG and
    the rate-controlled AccMPEG on an lte trace, under exact, fused,
    fused_exact and pallas. The trained detector is the server, Vigil's
    camera and SiEVE's cheap model."""
    from repro_torch.control import (ControlledAccMPEGPolicy,
                                     RateController, lte_trace)
    from repro_torch.control.controller import _controlled_prep
    from repro_torch.core.pipeline import NetworkConfig, make_reference
    from repro_torch.core.quality import QualityConfig
    from repro_torch.engine import (DDSPolicy, EAARPolicy,
                                    ReductoAccMPEGPolicy, ReductoPolicy,
                                    SiEVEPolicy, StreamingEngine,
                                    UniformPolicy, VigilPolicy,
                                    class_presence, frame_diff_feature)
    from repro_torch.engine import engine as engine_mod
    from repro_torch.kernels.mbcodec.kernel import LAUNCHES, chunk_kernel_name

    n_chunks = scene_frames.shape[0] // CHUNK_FRAMES
    chunks = [scene_frames[s:s + CHUNK_FRAMES]
              for s in range(0, n_chunks * CHUNK_FRAMES, CHUNK_FRAMES)]
    refs = make_reference(scene_frames, server, qp_hi=30)
    alpha = median_alpha(am, scene_frames[:1])
    qcfg = QualityConfig(alpha=alpha, gamma=2)
    # Reducto's and SiEVE's thresholds: the median change feature and the
    # median presence delta of the first chunk (their defaults drop no
    # frame of this panning scene), so that each keeps some frames and
    # drops others and Reducto+AccMPEG's kernel runs at several T
    feat = frame_diff_feature(chunks[0])[1:]
    thresh = float(feat.median()) + 1e-6
    pres = class_presence(server.predict(chunks[0]))
    delta = float((pres[1:] - pres[:-1]).abs().amax(-1).median()) + 1e-9
    kept = [int((frame_diff_feature(c) >= thresh)[1:].sum()) + 1
            for c in chunks]
    trace = lte_trace(seed=TRACE_SEED)
    log(f"baselines path: the same {scene_frames.shape[0]} frames, the "
        f"trained detector as server, Vigil camera and SiEVE model, "
        f"AccModel alpha {alpha:.6f}; Reducto thresh {thresh:.6f} (kept "
        f"frames a chunk {kept}), SiEVE delta {delta:.3e}; the controlled "
        f"run on lte seed {TRACE_SEED} (mean {trace.mean_bps:.0f} b/s, "
        f"rtt {trace.rtt_s} s), budget {CONTROL_BUDGET_S} s")

    def engine(impl, policy):
        if policy == "accmpeg_controlled":
            ctrl = RateController(delay_budget_s=CONTROL_BUDGET_S)
            return (StreamingEngine(server, impl=impl, trace=trace,
                                    controller=ctrl),
                    ControlledAccMPEGPolicy(am, ctrl, gamma=2))
        return StreamingEngine(server, impl=impl), {
            "uniform": lambda: UniformPolicy(38),
            "dds": DDSPolicy, "eaar": EAARPolicy,
            "reducto": lambda: ReductoPolicy(thresh=thresh),
            "vigil": lambda: VigilPolicy(server),
            "sieve": lambda: SiEVEPolicy(server, delta=delta),
            "reducto_accmpeg": lambda: ReductoAccMPEGPolicy(am, qcfg,
                                                            thresh),
        }[policy]()

    def expected(impl, policy):
        """Launches of one run: the warm-up's encode of a whole chunk and
        one encode a chunk (of its kept frames for Reducto+AccMPEG)."""
        if impl == "exact" or policy in ("uniform", "reducto", "sieve"):
            return {}
        if impl == "pallas":
            sent = sum(kept) if policy == "reducto_accmpeg" \
                else n_chunks * CHUNK_FRAMES
            return {"mbcodec_frame": CHUNK_FRAMES + sent}
        return {chunk_kernel_name(impl == "fused_exact"): 1 + n_chunks}

    # knobs set and applied with no wait on the card
    chunk = chunks[0]
    scores = am.scores(chunk[:1])
    ctrl = RateController(delay_budget_s=CONTROL_BUDGET_S)
    ctrl.level = 0.5
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    prep = _controlled_prep(chunk, scores, ctrl.knob_array("cuda"),
                            gamma=2)
    torch.cuda.set_sync_debug_mode(0)
    log(f"  _controlled_prep and knob_array under sync debug mode "
        f"'error': no synchronisation; keep {prep[2].tolist()}")

    results, shares, off_card = {}, {}, set()
    encode = engine_mod.jit_encode
    LAUNCHES.clear()  # every count to 0 just before the path
    t0 = time.perf_counter()
    for policy in BASELINES:
        for impl in BACKENDS:
            shares[policy, impl] = []
            engine_mod.jit_encode = _recording_encoder(shares[policy, impl])
            eng, pol = engine(impl, policy)
            results[policy, impl], moved, off = audited(
                lambda: eng.run(pol, scene_frames, refs=refs))
            engine_mod.jit_encode = encode
            off_card |= off
            hi = shares[policy, impl]
            log(f"  {policy} {impl}: launches {moved}"
                + (f", (high-QP share, its QP) per encode {hi}" if hi
                   else ""))
            if moved != expected(impl, policy):
                raise AssertionError(f"{policy} {impl} launched {moved}, "
                                     f"expected {expected(impl, policy)}")
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)  # read just after the path
    log(f"  baselines path ({CARD}): {secs:.2f} s under the audit for "
        f"{len(BASELINES) * len(BACKENDS)} runs; launches {launches}")
    if off_card:
        raise AssertionError(f"ops off the card: {sorted(off_card)}")
    log("  every op of the baseline runs ran on cuda (transfers aside)")
    if not any(0.0 < x < 1.0 for x, _ in shares["vigil", "exact"]):
        raise AssertionError(f"vigil's masks are all empty or all full: "
                             f"{shares['vigil', 'exact']}")

    rtt = NetworkConfig().rtt_s
    for (policy, impl), r in results.items():
        acc = [c.accuracy for c in r.chunks]
        nbytes = [c.bytes for c in r.chunks]
        if len(r.chunks) != n_chunks or not all(
                np.isfinite(acc + nbytes)) or not all(
                0.0 <= a <= 1.0 for a in acc) or min(nbytes) <= 0 or \
                r.method != policy and policy != "uniform":
            raise AssertionError(f"{policy} {impl}: malformed result "
                                 f"{r.method} {acc} {nbytes}")
        if policy == "dds" and any(c.extra_rtt_s != rtt for c in r.chunks):
            raise AssertionError(f"dds {impl}: extra_rtt_s is not the RTT")
        if policy == "accmpeg_controlled" and not all(
                c.queue_s >= 0.0 for c in r.chunks):
            raise AssertionError("controlled run: negative queue")
        # QP maps that do not depend on the backend's own output
        n = {"dds": n_chunks, "vigil": n_chunks,
             "reducto_accmpeg": n_chunks, "eaar": 1}.get(policy, 0)
        if impl in ("fused_exact", "pallas") and n:
            rel = max(abs(a.bytes - b.bytes) / b.bytes for a, b in zip(
                r.chunks[:n], results[policy, "exact"].chunks[:n]))
            log(f"  {policy} {impl}: bytes of {n} chunk(s) within "
                f"{rel:.3e} of exact")
            if rel > 1e-3:
                raise AssertionError(f"{policy} {impl} bytes differ from "
                                     f"exact")

    # a second run of each outside the audit gives the timings
    for policy in BASELINES:
        for impl in BACKENDS:
            eng, pol = engine(impl, policy)
            r = eng.run(pol, scene_frames, refs=refs)
            s = r.summary()
            log(f"  {policy} {impl} summary: encode_s "
                f"{[round(c.encode_s * 1e3, 4) for c in r.chunks]} ms, "
                f"overhead_s {[round(c.overhead_s * 1e3, 4) for c in r.chunks]}"
                f" ms, {json.dumps(s)}"
                + (f", knob path qp_hi {[round(k.qp_hi, 2) for k, _ in eng.controller.history]}"
                   if eng.controller is not None else ""))
    return launches


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
    torch.use_deterministic_algorithms(True)
    net = train_final_dnn("detection", "dashcam", steps=DNN_STEPS,
                          H=HEIGHT, W=WIDTH_PX, width=32, cache=False)
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    secs = time.perf_counter() - t0
    after = held_loss(net)
    log(f"  train_final_dnn: {DNN_STEPS} steps (deterministic algorithms) "
        f"in {secs:.3f} s (data included); held-batch detection loss "
        f"{before:.6f} -> {after:.6f}")
    if not after < before:
        raise AssertionError("train_final_dnn did not lower the held loss")
    # read just after the path: make_labels' and train_accmodel's labels
    made = LAUNCHES["accgrad_reduce"]
    if made != 2 * (n // LABEL_BATCH):
        raise AssertionError(f"accgrad_reduce launched {made} times on the "
                             f"training path")
    rows["accgrad_reduce"]["launches"] = \
        rows["accgrad_reduce"].get("launches", 0) + made
    return net


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

    # what deterministic cuBLAS calls need (the detector's training):
    # cuBLAS workspaces of 4 MiB, 8 of them
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    launches = closed_loop_phase(am)
    log(f"closed-loop fleet path ({CARD}): launches {launches}")
    launches = multitenant_phase(rows, dnn, am)
    log(f"multi-tenant fleet path ({CARD}): launches {launches}")
    t0 = time.perf_counter()
    detector = training_phase(rows, dnn)
    log(f"training path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = baselines_phase(frames, detector, am)
    log(f"baselines path ({CARD}): {time.perf_counter() - t0:.2f} s, "
        f"launches {launches}")
    del dnn, am, detector
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
