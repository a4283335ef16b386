"""ctypes wrapper of the CUDA kernel in ``csrc/decode_attn.cu``.

``decode_attn_cuda`` launches ``decode_attn_kernel`` once per call over
splits of the cache, the last block of each (b, kv) merging its splits
(it replaces ``repro/kernels/decode_attn/kernel.py::decode_attn_pallas``);
on an int8 cache a block takes :func:`heads_per_block` KV heads at once,
and with a bf16 q at head dim 64 or 128 (:func:`mma_body`) its products
run on the tensor cores, over one wave of splits (:func:`mma_split_plan`);
so do a bf16 cache's at those head dims and 5 to 8 query heads a KV head
(:func:`bf16_mma_body`), or one (:func:`bf16_g1_body`), one KV head a
block.
It takes CUDA tensors, q, k and v all bf16 or all fp32, or k and v in the
int8 form ``{"q": int8, "s": fp32 (..., 1)}`` beside a bf16 or fp32 q
(read as ``cache_read(c, q.dtype)``, without a dequantized copy). It
reads the cache as stored, allocates its output and scratch, launches on
the current stream without synchronising, and raises on any CUDA error
the launch reports. ``pos`` is a Python int, or an int32 CUDA tensor of one
element that the kernel reads on the card: the grid and scratch depend
on the cache's length only, so one captured CUDA graph serves every
``pos``. :data:`LAUNCHES` counts its calls, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches per kernel: "decode_attn" (one launch per call)
LAUNCHES: collections.Counter = collections.Counter()

MAX_GROUP = 8  # query heads per KV head (the kernel's MAX_GROUP)
MAX_ROWS = 65535  # B * KV: grid.y and the kernel's tickets
HEAD_DIMS = (32, 64, 80, 128)
SPLIT_ALIGN = 64  # positions: a whole number of the bf16/fp32 body's tiles
INT8_TILE = 128  # (position, head) rows of walk_int8's tile (Q8_TP)
MIN_SPLIT, MAX_SPLIT = 128, 1024  # positions of a split
# blocks over the whole cache, per SM: with the cache half full, about 4
# hold positions, one wave at the kernel's 4 resident blocks per SM (the
# CUDA-core int8 body's too, walk_int8, at G <= 2). On stablelm's int8
# cache (128 groups of 4 heads) that is splits of 256 positions, chosen
# on the H100 over 128 and 512
BLOCKS_PER_SM = 8
INT8_BLOCKS_PER_SM = 8
# the int8 body on the tensor cores (walk_int8_mma): bf16 q, these head
# dims, every group size (the kernel's MMA_BODY). Its splits give each SM
# about MMA_BLOCKS_PER_SM blocks, all resident at once: on the H100 two
# long blocks an SM beat three shorter ones at moonshot-v1-16b-a3b's shape
# (0.0357 against 0.0388 ms, tools/decode_attn_splits.py). Past
# MMA_WIDE_GROUP query heads a KV head (p.v as O += P V, 8 warps a block,
# one resident an SM) a block takes one KV head: at llama-3.2-vision-90b's
# G 8 one head and one split a block beat 4 heads over 4 to 8 splits,
# whose merge cost more than it spread (tools/decode_attn_splits.py)
MMA_HEAD_DIMS, MMA_WIDE_GROUP = (64, 128), 4
MMA_BLOCKS_PER_SM = 2
# the bf16 cache's body on the tensor cores (walk_bf16_mma): a bf16 q on a
# bf16 cache at MMA_HEAD_DIMS, past MMA_WIDE_GROUP query heads a KV head
# (jamba-1.5-large-398b's G 8 at hd 128; the kernel's BF16_MMA_BODY); one
# KV head a block, its splits from mma_split_plan as the int8 body's. It
# takes one query head a KV head too (seamless-m4t-large-v2's hd 64,
# olmoe-1b-7b's hd 128; bf16_g1_body), with a ring of 96 KB: at their
# B*KV = 256 rows two blocks an SM give one split a row, no merge

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache()
def _lib():
    lib = build.load("decode_attn")
    lib.decode_attn.argtypes = [_P] * 9 + [_I] * 11 + [_P]
    lib.decode_attn.restype = _I
    lib.decode_attn_blocks_per_sm.argtypes = [_I] * 4 + [_P]
    lib.decode_attn_blocks_per_sm.restype = _I
    return lib


@functools.lru_cache()
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mma_body(q_dtype, int8: bool, hd: int, G: int) -> bool:
    """Whether ``decode_attn_kernel`` takes its tensor-core int8 body
    (``walk_int8_mma``) for q of ``q_dtype``: a bf16 q on the int8 cache at
    head dim 64 or 128, any of the 1..8 query heads per KV head (P V turned
    around past 4)."""
    return (int8 and q_dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS
            and 1 <= G <= MAX_GROUP)


def bf16_mma_body(q_dtype, int8: bool, hd: int, G: int) -> bool:
    """Whether ``decode_attn_kernel`` takes its tensor-core bf16 body
    (``walk_bf16_mma``): a bf16 q on a bf16 cache at head dim 64 or 128,
    5 to 8 query heads per KV head (one is :func:`bf16_g1_body`). Every
    other bf16 and fp32 shape keeps the CUDA-core body; the int8 cache is
    :func:`mma_body`'s."""
    return (not int8 and q_dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS
            and MMA_WIDE_GROUP < G <= MAX_GROUP)


def bf16_g1_body(q_dtype, int8: bool, hd: int, G: int) -> bool:
    """Whether ``decode_attn_kernel`` takes its tensor-core bf16 body
    (``walk_bf16_mma``) at one query head a KV head, with a ring that
    lets two blocks share an SM: a bf16 q on a bf16 cache at head dim 64
    or 128, G 1. Never together with :func:`mma_body` or
    :func:`bf16_mma_body`."""
    return (not int8 and q_dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS
            and G == 1)


@functools.lru_cache()
def blocks_per_sm(device: torch.device, q_dtype, int8: bool, hd: int,
                  G: int) -> int:
    """Blocks of the kernel for (q's type, cache, hd, G) that one SM of
    ``device`` holds at once, from the CUDA occupancy calculator on the
    built kernel (its registers and shared memory)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().decode_attn_blocks_per_sm(
            int(q_dtype == torch.bfloat16), int(int8), hd, G,
            ctypes.addressof(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"decode_attn's occupancy query failed with "
                           f"cudaError_t {err} ({blocks.value} blocks)")
    return blocks.value


def mma_split_plan(rows: int, S: int, slots: int):
    """(split_len, nsplit) of the tensor-core bodies for ``rows`` blocks
    of query groups over a cache of ``S`` positions, ``slots`` blocks to
    run at once (SMs x :data:`MMA_BLOCKS_PER_SM`, or the fewer that fit):
    as many splits as one wave holds (``slots // rows``, at least 1, at
    most S), each at most ``split_len`` long; they cover 0..S-1 and none
    starts past it. The kernel spreads positions 0..pos evenly over the
    nsplit splits at run time, so the grid and scratch still depend on
    (rows, S, slots) alone."""
    nsplit = min(max(slots // rows, 1), S)
    split_len = -(-S // nsplit)
    return split_len, -(-S // split_len)


def heads_per_block(KV: int, int8: bool) -> int:
    """KV heads a block of the kernel takes: on the int8 cache 4 (or 2)
    where they divide ``KV``, whose rows then lie together in the cache,
    4 x 80 bytes a position at stablelm's head dim; else 1."""
    if int8:
        for kvg in (4, 2):
            if KV % kvg == 0:
                return kvg
    return 1


def split_plan(rows: int, S: int, sms: int, int8: bool = False):
    """(split_len, nsplit) for ``rows`` blocks of query groups (B*KV /
    :func:`heads_per_block`) over a cache of ``S`` positions, whatever
    ``pos`` is: about :data:`BLOCKS_PER_SM`
    (an ``int8`` cache: :data:`INT8_BLOCKS_PER_SM`) thread blocks per SM
    over the whole cache, splits of :data:`MIN_SPLIT` to :data:`MAX_SPLIT`
    positions, a multiple of :data:`SPLIT_ALIGN` (:data:`INT8_TILE`);
    they cover 0..S-1 and none starts past it."""
    per_sm, align = ((INT8_BLOCKS_PER_SM, INT8_TILE) if int8
                     else (BLOCKS_PER_SM, SPLIT_ALIGN))
    per_block = -(-S * rows // (per_sm * sms))
    split_len = -(-per_block // align) * align
    split_len = min(max(split_len, MIN_SPLIT), MAX_SPLIT)
    return split_len, -(-S // split_len)


def launch_plan(device, q_dtype, int8: bool, B: int, KV: int, G: int,
                hd: int, S: int):
    """(KV heads a block, split_len, nsplit) of one call on ``device``:
    :func:`mma_split_plan` over the SMs' :data:`MMA_BLOCKS_PER_SM` blocks
    (or the fewer :func:`blocks_per_sm` that fit) for the tensor-core
    bodies, one KV head a block past :data:`MMA_WIDE_GROUP` (and on any
    bf16 cache); else :func:`split_plan`."""
    mma = (mma_body(q_dtype, int8, hd, G)
           or bf16_mma_body(q_dtype, int8, hd, G)
           or bf16_g1_body(q_dtype, int8, hd, G))
    kvg = 1 if mma and G > MMA_WIDE_GROUP else heads_per_block(KV, int8)
    rows, sms = B * KV // kvg, _sm_count(device)
    if mma:
        slots = sms * min(MMA_BLOCKS_PER_SM,
                          blocks_per_sm(device, q_dtype, int8, hd, G))
        return (kvg, *mma_split_plan(rows, S, slots))
    return (kvg, *split_plan(rows, S, sms, int8=int8))


def _check_tensor(name, t, q, dtype, align=16):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != q.device:
        raise ValueError("q, k and v lie on different devices")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (q is {q.dtype}), got "
                         f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:  # the kernel reads rows in 16-byte vectors
        raise ValueError(f"{name} must start on a {align}-byte boundary")


def _check(q, k, v, pos):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    _check_tensor("q", q, q, q.dtype)
    if isinstance(k, dict) != isinstance(v, dict):
        raise ValueError("k and v must both be tensors or both the int8 "
                         "form {'q', 's'}")
    if isinstance(k, dict):
        for name, c in (("k", k), ("v", v)):
            if set(c) != {"q", "s"}:
                raise ValueError(f"the int8 form of {name} holds 'q' and "
                                 f"'s', got {sorted(c)}")
            _check_tensor(f"{name}['q']", c["q"], q, torch.int8)
            _check_tensor(f"{name}['s']", c["s"], q, torch.float32, 4)
        k, v, scales = k["q"], v["q"], (k["s"], v["s"])
    else:
        _check_tensor("k", k, q, q.dtype)
        _check_tensor("v", v, q, q.dtype)
        scales = None
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, KV, G, hd) and k (B, S, KV, hd), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, KV, G, hd = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} as (B, S, KV, hd)")
    if scales is not None and any(tuple(t.shape) != (B, S, KV, 1)
                                  for t in scales):
        raise ValueError(f"the int8 form's scales must be (B, S, KV, 1) = "
                         f"{(B, S, KV, 1)}, got "
                         f"{[tuple(t.shape) for t in scales]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"group size {G} not in 1..{MAX_GROUP}")
    if not 1 <= B * KV <= MAX_ROWS:
        raise ValueError(f"B*KV = {B * KV} outside one launch's "
                         f"1..{MAX_ROWS}")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32:
            raise ValueError(f"a pos tensor must be int32, got {pos.dtype}")
        if pos.device != q.device:
            raise ValueError(f"a pos tensor must lie on q's device "
                             f"{q.device}, got {pos.device}")
        if pos.numel() != 1:
            raise ValueError(f"a pos tensor must hold one element, got "
                             f"{tuple(pos.shape)}")
    elif not 0 <= int(pos) < S:
        raise ValueError(f"pos {pos} outside the cache's 0..{S - 1}")


def decode_attn_cuda(q: torch.Tensor, k, v, pos) -> torch.Tensor:
    """q (B, KV, G, hd); k, v (B, S, KV, hd) of q's type, or both the int8
    form ``{"q": int8 (B, S, KV, hd), "s": fp32 (B, S, KV, 1)}``;
    positions 0..pos attend -> (B, KV, G, hd) fp32. ``pos``: an int
    (checked here), or an int32 CUDA tensor of one element on q's device,
    read by the kernel; a value of it outside 0..S-1 gives NaN throughout
    the output."""
    _check(q, k, v, pos)
    ks = vs = None  # the int8 form's scales
    if isinstance(k, dict):
        ks, vs = k["s"].data_ptr(), v["s"].data_ptr()
        k, v = k["q"], v["q"]
    B, KV, G, hd = q.shape
    S = k.shape[1]
    if isinstance(pos, torch.Tensor):
        pos_ptr, pos = pos.data_ptr(), 0
    else:
        pos_ptr, pos = None, int(pos)
    kvg, split_len, nsplit = launch_plan(q.device, q.dtype, ks is not None,
                                         B, KV, G, hd, S)
    with torch.cuda.device(q.device):
        out = torch.empty((B, KV, G, hd), dtype=torch.float32,
                          device=q.device)
        part_acc = torch.empty((B * KV * nsplit * G * hd,),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B * KV * nsplit * G * 2,),
                              dtype=torch.float32, device=q.device)
        err = _lib().decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ks, vs, pos_ptr,
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, S,
            KV, G, hd, pos, split_len, nsplit, kvg,
            int(q.dtype == torch.bfloat16), int(ks is not None),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES["decode_attn"] += 1
    return out
