"""The port's plain versions of the LM kernels against the reference.

``decode_attn`` and ``wkv6`` serve CPU tensors through their plain
versions (the CUDA kernels are held against these on the card, in
``tests/test_torch_cuda.py``). Here each plain version meets, on the same
numpy inputs, the reference's oracle, its Pallas kernel in interpret mode
and, for WKV, the reference model's chunked form. Tolerances are the
reference's own kernel bounds (``tests/test_kernels.py``): decode_attn
atol 1e-5, rtol 1e-4, bf16 inputs included, since both sides widen the
same bf16 values; wkv6 atol 2e-4, rtol 1e-3.
"""
import inspect

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attn as ref_decode_attn
from repro.kernels.decode_attn.ref import decode_attn_ref as ref_oracle
from repro.kernels.wkv6.ops import wkv6 as ref_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as ref_wkv6_oracle
from repro.models.rwkv6 import wkv_chunked as ref_wkv_chunked
from repro_torch.kernels.decode_attn import kernel as dk
from repro_torch.kernels.decode_attn.kernel import (INT8_TILE, MAX_SPLIT,
                                                    MIN_SPLIT, SPLIT_ALIGN,
                                                    bf16_g1_body,
                                                    bf16_mma_body,
                                                    heads_per_block,
                                                    mma_body,
                                                    mma_split_plan,
                                                    split_plan)
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import decode_attn_ref
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import (MAX_SEG_LEN, MAX_SEGMENTS,
                                          SEG_CHUNK, segment_plan, wkv6_ref,
                                          wkv6_segmented, wkv_chunked)

ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
WKV_TOL = dict(atol=2e-4, rtol=1e-3)


def _attn_inputs(B, S, KV, G, hd, seed, bf16=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd))]
    if bf16:  # the same bf16 values on both sides
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dims", [(2, 256, 2, 4, 32, 255),
                                  (1, 1024, 4, 8, 64, 700),
                                  (2, 96, 1, 2, 16, 40),
                                  (2, 200, 5, 3, 64, 0),   # smollm's G=3
                                  (1, 128, 2, 2, 32, 100),
                                  (2, 256, 2, 1, 128, 200),  # olmoe's G=1
                                  (1, 192, 2, 8, 128, 191)])  # qwen's G=8
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attn_plain_matches_reference(dims, bf16):
    """Against the reference's oracle and its kernel in interpret mode (the
    reference's test shapes, plus G=3 at pos 0, and hd 128 at G 1 and 8)."""
    B, S, KV, G, hd, pos = dims
    q, k, v = _attn_inputs(B, S, KV, G, hd, seed=S, bf16=bf16)
    got = decode_attn(*map(_torch, (q, k, v)), pos)
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, hd)
    np.testing.assert_array_equal(
        got.numpy(), decode_attn_ref(*map(_torch, (q, k, v)), pos).numpy())
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (ref_oracle(jq, jk, jv, pos),
                 ref_decode_attn(jq, jk, jv, pos, impl="interpret", blk=64)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATTN_TOL)


@pytest.mark.parametrize("dims", [(2, 256, 2, 4, 32, 255),
                                  (1, 1024, 4, 8, 64, 700),
                                  (2, 200, 5, 3, 64, 0),
                                  (2, 256, 4, 1, 128, 100)])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attn_tensor_pos_matches_reference_array_pos(dims, bf16):
    """``pos`` as a one-element int32 tensor against the reference's kernel
    given ``pos`` as a (1,) int32 array (its own form, ``kernel.py:58``),
    in interpret mode; the same as the int form, bit for bit."""
    B, S, KV, G, hd, pos = dims
    q, k, v = _attn_inputs(B, S, KV, G, hd, seed=S + 1, bf16=bf16)
    tq, tk, tv = map(_torch, (q, k, v))
    got = decode_attn(tq, tk, tv, torch.tensor([pos], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(),
                                  decode_attn(tq, tk, tv, pos).numpy())
    want = ref_decode_attn(*map(jnp.asarray, (q, k, v)),
                           jnp.array([pos], jnp.int32), impl="interpret",
                           blk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


_PLAN_SIZES = [(80, 132), (640, 132), (1, 132), (10, 8), (65535, 132)]


@pytest.mark.parametrize("rows,sms,int8", [
    *(pytest.param(r, n, False, id=f"{r}-{n}") for r, n in _PLAN_SIZES),
    *(pytest.param(r, n, True, id=f"{r}-{n}-int8")
      for r, n in _PLAN_SIZES + [(128, 132)])])  # stablelm's 4-head groups
def test_decode_attn_split_plan_depends_on_the_cache_length_only(rows, sms,
                                                                 int8):
    """The kernel's grid and scratch come from (blocks of query groups, S,
    SM count, the cache's type) alone, so one plan (and one captured graph)
    serves every pos: its splits are whole multiples of the alignment (the
    int8 body's tile on an int8 cache) within the length bounds, cover
    0..S-1, so that every pos has its split, and none starts past S-1."""
    assert list(inspect.signature(split_plan).parameters) == [
        "rows", "S", "sms", "int8"]
    align = INT8_TILE if int8 else SPLIT_ALIGN
    for S in range(1, 32769):
        split_len, nsplit = split_plan(rows, S, sms, int8=int8)
        assert split_len % align == 0
        assert MIN_SPLIT <= split_len <= MAX_SPLIT
        assert (nsplit - 1) * split_len < S <= nsplit * split_len


@pytest.mark.parametrize("rows,slots", [(64, 396), (80, 528), (1, 396),
                                        (64, 64), (1000, 396), (3, 8),
                                        (32, 264)])  # llama-vision's
def test_decode_attn_mma_split_plan_fills_one_wave(rows, slots):
    """The tensor-core int8 body's grid: as many splits of each row group as
    one wave of ``slots`` resident blocks holds (moonshot's 64 groups of 4
    heads on 132 SMs x 3: 6), at least one, never more than S; they cover
    0..S-1 and none starts past it, and the kernel's run-time split of
    0..pos (ceil((pos + 1) / nsplit) positions each) fits split_len and
    nsplit for every pos."""
    assert list(inspect.signature(mma_split_plan).parameters) == [
        "rows", "S", "slots"]
    for S in list(range(1, 300)) + [2048, 4500, 32768]:
        split_len, nsplit = mma_split_plan(rows, S, slots)
        assert 1 <= nsplit <= max(slots // rows, 1)
        assert rows * nsplit <= max(slots, rows)
        assert (nsplit - 1) * split_len < S <= nsplit * split_len
        for pos in {0, S // 2, S - 1}:
            length = -(-(pos + 1) // nsplit)
            assert length <= split_len and -(-(pos + 1) // length) <= nsplit


@pytest.mark.parametrize("dtype,int8,hd,G,want", [
    (torch.bfloat16, True, 128, 1, True),   # moonshot-v1-16b-a3b
    (torch.bfloat16, True, 128, 2, True),   # two query heads a KV head
    (torch.bfloat16, True, 64, 3, True),    # smollm's int8 shape
    (torch.bfloat16, True, 80, 1, False),   # stablelm-3b: walk_int8
    (torch.bfloat16, True, 128, 8, True),   # llama-3.2-vision-90b's G 8
    (torch.bfloat16, True, 128, 5, True),   # past G 4: p.v as O += P V
    (torch.bfloat16, True, 128, 6, True),
    (torch.bfloat16, True, 128, 7, True),   # yi-34b's 56 heads over 8
    (torch.bfloat16, True, 64, 8, True),    # the same code at hd 64
    (torch.float32, True, 128, 1, False),   # fp32 q: not bf16 operands
    (torch.float32, True, 128, 8, False),   # walk_int8 (TIGHT)
    (torch.bfloat16, False, 128, 8, False),  # the bf16 cache's own body
    (torch.bfloat16, False, 128, 1, False)])
def test_decode_attn_mma_body_takes_bf16_q_at_hd_64_and_128(dtype, int8, hd,
                                                             G, want):
    assert mma_body(dtype, int8, hd, G) is want


@pytest.mark.parametrize("S", [2048, 6404])
def test_decode_attn_launch_plan_at_llama_vision_shapes(monkeypatch, S):
    """llama-3.2-vision-90b's int8 rows (B 16, KV 8, G 8, hd 128; the self
    layers' S 2048, the cross layers' 6,404) on an H100's 132 SMs, one
    resident block of the tensor-core body's 8 warps an SM: one KV head a
    block, one split, one wave of 128 blocks on 132 slots; the split
    covers 0..S-1."""
    monkeypatch.setattr(dk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(dk, "blocks_per_sm", lambda *args: 1)
    kvg, split_len, nsplit = dk.launch_plan(torch.device("cuda"),
                                            torch.bfloat16, True, 16, 8, 8,
                                            128, S)
    assert (kvg, split_len, nsplit) == (1, S, 1)
    assert 16 * 8 // kvg * nsplit <= 132
    # G <= 4 keeps 4 KV heads a block over two blocks an SM
    monkeypatch.setattr(dk, "blocks_per_sm", lambda *args: 3)
    assert dk.launch_plan(torch.device("cuda"), torch.bfloat16, True, 16, 8,
                          4, 128, S)[::2] == (4, 8)


@pytest.mark.parametrize("dtype,int8,hd,G,want", [
    *(pytest.param(torch.bfloat16, False, hd, G, True, id=f"bf16-{hd}-{G}")
      for hd in (64, 128) for G in range(5, 9)),  # jamba's: 128, 8
    *(pytest.param(torch.bfloat16, False, hd, G, False,
                   id=f"bf16-{hd}-{G}-cuda-core")
      for hd in (64, 128) for G in range(1, 5)),  # smollm's, olmoe's, ..
    pytest.param(torch.bfloat16, False, 32, 8, False, id="bf16-32-8"),
    pytest.param(torch.bfloat16, False, 80, 8, False, id="bf16-80-8"),
    pytest.param(torch.bfloat16, False, 80, 5, False, id="bf16-80-5"),
    pytest.param(torch.float32, False, 128, 8, False, id="fp32-128-8"),
    pytest.param(torch.float32, False, 64, 5, False, id="fp32-64-5"),
    pytest.param(torch.bfloat16, True, 128, 8, False, id="int8-128-8"),
    pytest.param(torch.bfloat16, True, 64, 5, False, id="int8-64-5")])
def test_decode_attn_bf16_mma_body_takes_bf16_cache_at_g_5_to_8(dtype, int8,
                                                               hd, G, want):
    """The tensor-core bf16 body (walk_bf16_mma) takes a bf16 q on a bf16
    cache at hd 64 and 128 with 5 to 8 query heads a KV head; G 1..4, hd 32
    and 80 and fp32 do not (G 1 at hd 64 and 128 is ``bf16_g1_body``'s,
    the same body with a smaller ring; the rest the CUDA-core body's), and
    the int8 cache stays ``mma_body``'s: the two predicates never both
    hold."""
    assert bf16_mma_body(dtype, int8, hd, G) is want
    assert not (want and mma_body(dtype, int8, hd, G))
    if int8:
        assert mma_body(dtype, int8, hd, G)


@pytest.mark.parametrize("bps,nsplit", [(1, 1), (2, 2), (3, 2)])
def test_decode_attn_launch_plan_at_jamba_shape(monkeypatch, bps, nsplit):
    """jamba-1.5-large-398b's attention layer (B 16, KV 8, G 8, hd 128, S
    2048, a bf16 cache) on an H100's 132 SMs: one KV head a block, as many
    splits a row as one wave of min(bps, MMA_BLOCKS_PER_SM) resident
    blocks an SM holds (one split at one block an SM, two at two), so the
    128 rows' blocks fill one wave and no more; the splits cover 0..S-1."""
    monkeypatch.setattr(dk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(dk, "blocks_per_sm", lambda *args: bps)
    kvg, split_len, nsplit_got = dk.launch_plan(torch.device("cuda"),
                                                torch.bfloat16, False, 16, 8,
                                                8, 128, 2048)
    slots = 132 * min(bps, dk.MMA_BLOCKS_PER_SM)
    assert (kvg, nsplit_got) == (1, nsplit)
    assert 16 * 8 * nsplit <= slots < 16 * 8 * (nsplit + 1)
    assert (nsplit - 1) * split_len < 2048 <= nsplit * split_len
    assert split_len == -(-2048 // nsplit)


@pytest.mark.parametrize("KV,G,hd,S", [(5, 3, 64, 2048),    # smollm
                                       (8, 4, 128, 2048),   # G 4: CUDA-core
                                       (32, 1, 80, 2048),   # stablelm's hd
                                       (16, 2, 64, 2048),   # G 2 at hd 64
                                       (8, 3, 128, 1024)])  # G 3 at hd 128
def test_decode_attn_launch_plan_keeps_split_plan_for_cuda_core_bf16(
        monkeypatch, KV, G, hd, S):
    """smollm's bf16 shape, G 2 to 4 at hd 64 and 128 and G 1 at hd 80
    keep the CUDA-core body's grid: split_plan's over the B*KV rows, one KV
    head a block, without asking for the occupancy."""
    def no_query(*args):
        raise AssertionError("the CUDA-core body's plan asks no occupancy")

    monkeypatch.setattr(dk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(dk, "blocks_per_sm", no_query)
    assert not bf16_mma_body(torch.bfloat16, False, hd, G)
    assert not bf16_g1_body(torch.bfloat16, False, hd, G)
    assert dk.launch_plan(torch.device("cuda"), torch.bfloat16, False, 16,
                          KV, G, hd, S) == (1, *split_plan(16 * KV, S, 132))


@pytest.mark.parametrize("dtype,int8,hd,G,want", [
    pytest.param(torch.bfloat16, False, 64, 1, True, id="bf16-64-1"),
    pytest.param(torch.bfloat16, False, 128, 1, True, id="bf16-128-1"),
    *(pytest.param(torch.bfloat16, False, hd, G, False, id=f"bf16-{hd}-{G}")
      for hd in (64, 128) for G in range(2, 9)),
    pytest.param(torch.bfloat16, False, 32, 1, False, id="bf16-32-1"),
    pytest.param(torch.bfloat16, False, 80, 1, False, id="bf16-80-1"),
    pytest.param(torch.float32, False, 64, 1, False, id="fp32-64-1"),
    pytest.param(torch.float32, False, 128, 1, False, id="fp32-128-1"),
    pytest.param(torch.bfloat16, True, 64, 1, False, id="int8-64-1"),
    pytest.param(torch.bfloat16, True, 128, 1, False, id="int8-128-1"),
    pytest.param(torch.float32, True, 128, 1, False, id="int8-fp32-128-1")])
def test_decode_attn_bf16_g1_body_takes_bf16_cache_at_g_1(dtype, int8, hd, G,
                                                        want):
    """The tensor-core bf16 body at one query head a KV head
    (walk_bf16_mma) takes a bf16 q on a bf16 cache at hd 64 and 128, G 1
    (seamless-m4t-large-v2's and olmoe-1b-7b's); G 2..8, hd 32 and 80, fp32
    and the int8 cache do not, and it never holds together with
    ``mma_body`` or ``bf16_mma_body``."""
    assert bf16_g1_body(dtype, int8, hd, G) is want
    if want:
        assert not mma_body(dtype, int8, hd, G)
        assert not bf16_mma_body(dtype, int8, hd, G)


@pytest.mark.parametrize("bps", [1, 2, 3, 4])
@pytest.mark.parametrize("hd,S", [(64, 2048),    # seamless's self layers
                                  (64, 1024),    # its cross layers
                                  (128, 2048)])  # olmoe-1b-7b
def test_decode_attn_launch_plan_at_g1_shapes(monkeypatch, hd, S, bps):
    """seamless-m4t-large-v2's self (S 2048) and cross (S 1,024) shapes and
    olmoe-1b-7b's (hd 128), B 16, KV 16, G 1 on a bf16 cache, on an H100's
    132 SMs: walk_bf16_mma's plan asks the occupancy of its own
    instantiation and takes one KV head a block and one split a row (256
    rows against 132 x min(bps, MMA_BLOCKS_PER_SM) slots), so at two or
    more resident blocks an SM the 256 blocks fill one wave, each writing
    its row with no merge; the split covers 0..S-1."""
    asked = []

    def blocks(device, q_dtype, int8, hd_, G):
        asked.append((q_dtype, int8, hd_, G))
        return bps

    monkeypatch.setattr(dk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(dk, "blocks_per_sm", blocks)
    assert bf16_g1_body(torch.bfloat16, False, hd, 1)
    kvg, split_len, nsplit = dk.launch_plan(torch.device("cuda"),
                                            torch.bfloat16, False, 16, 16, 1,
                                            hd, S)
    assert asked == [(torch.bfloat16, False, hd, 1)]
    slots = 132 * min(bps, dk.MMA_BLOCKS_PER_SM)
    assert (kvg, split_len, nsplit) == (1, S, 1)
    assert (kvg, split_len, nsplit) == (1, *mma_split_plan(256, S, slots))
    assert (nsplit - 1) * split_len < S <= nsplit * split_len
    if bps >= 2:
        assert 16 * 16 * nsplit <= slots


@pytest.mark.parametrize("KV,int8,kvg", [(32, True, 4), (5, True, 1),
                                         (2, True, 2), (12, True, 4),
                                         (32, False, 1), (5, False, 1)])
def test_decode_attn_heads_per_block_divide_the_kv_heads(KV, int8, kvg):
    """On an int8 cache a block takes 4 (or 2) KV heads of one b where they
    divide KV (stablelm-3b's 32: groups of 4); a bf16 or fp32 cache one."""
    assert heads_per_block(KV, int8) == kvg
    assert KV % kvg == 0


def _wkv_inputs(B, S, H, hd, seed, log_decay=None, zero_s0=False):
    """Seeded inputs as the reference's tests draw them: r, k, v x0.5,
    log-decay -exp(N(-1, 0.5)) unless given (a constant, or "uniform-8":
    a uniform draw in [-8, -1e-4]), u x0.3, s0 x0.2."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    if log_decay is None:
        ld = -np.exp(0.5 * rng.standard_normal((B, S, H, hd)) - 1.0)
    elif log_decay == "uniform-8":
        ld = rng.uniform(-8.0, -1e-4, (B, S, H, hd))
    else:
        ld = np.full((B, S, H, hd), log_decay)
    u = 0.3 * rng.standard_normal((H, hd))
    s0 = 0.2 * rng.standard_normal((B, H, hd, hd))
    if zero_s0:
        s0 = np.zeros_like(s0)
    return [x.astype(np.float32) for x in (r, k, v, ld, u, s0)]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **WKV_TOL)


@pytest.mark.parametrize("dims", [(2, 64, 2, 16, 16), (1, 128, 4, 32, 64),
                                  (2, 100, 2, 16, 32), (1, 32, 1, 8, 32),
                                  (2, 1, 3, 64, 64)])
def test_wkv6_plain_matches_reference(dims):
    """The port's CPU path (``wkv_chunked``) against the reference's oracle,
    its kernel in interpret mode at chunk c, and the reference model's
    chunked form; the port's oracle against the reference's. The last
    shape is one decode step."""
    B, S, H, hd, c = dims
    xs = _wkv_inputs(B, S, H, hd, seed=S)
    ts, js = [torch.from_numpy(x) for x in xs], [jnp.asarray(x) for x in xs]
    got = wkv6(*ts)
    _close(got, wkv_chunked(*ts))
    for want in (ref_wkv6_oracle(*js), ref_wkv6(*js, impl="interpret",
                                                 chunk=c),
                 ref_wkv_chunked(*js)):
        _close(got, want)
    _close(wkv6_ref(*ts), ref_wkv6_oracle(*js))


@pytest.mark.parametrize("log_decay,chunk", [(-3.0, 64), (-8.0, 32)])
def test_wkv6_plain_is_finite_for_fast_decays(log_decay, chunk):
    """Trained RWKV6 channels decay fast. At log_decay = -3 and chunk 64
    the reference's Pallas kernel (``repro/kernels/wkv6/kernel.py:44-47``)
    evaluates exp(Lx[t] - L[s]) for s >= t too, where the exponent reaches
    +189; it overflows to inf, and inf * 0 under the triangle mask gives
    NaN (560 NaNs in a (1, 64, 1, 16) output, jax 0.9.0, CPU). The port's
    CUDA kernel forms only the pairs s < t; its plain version, like the
    reference model's chunked form, masks with ``where``. Both stay finite
    and match the sequential oracle."""
    xs = _wkv_inputs(1, 128, 2, 16, seed=7, log_decay=log_decay)
    ts = [torch.from_numpy(x) for x in xs]
    for got in (wkv6(*ts), wkv_chunked(*ts, chunk=chunk)):
        assert all(bool(torch.isfinite(t).all()) for t in got)
        _close(got, ref_wkv6_oracle(*map(jnp.asarray, xs)))


# The CUDA kernel's decomposition (segments with local states chained in
# rank order, chunks of 16 cut into sub-blocks of 8, every exponent <= 0),
# written plainly, against the reference's oracle and, where its decays
# keep the reference kernel finite, its Pallas kernel in interpret mode.
# Segment counts 1..8 are given as they stand, so that a count past what
# the sequence fills leaves empty segments; S=1000 with one segment of 128
# takes 8 rounds.
@pytest.mark.parametrize("S,n_seg,hd,log_decay", [
    (1, 1, 64, None), (1, 8, 32, "uniform-8"),
    (15, 1, 32, None), (15, 8, 64, -3.0),
    (17, 2, 64, None), (17, 5, 32, "uniform-8"),
    (129, 3, 32, -3.0), (129, 8, 64, None), (129, 6, 64, "uniform-8"),
    (1000, 1, 32, "uniform-8"), (1000, 4, 64, None), (1000, 7, 32, -3.0),
    (1000, 8, 64, "uniform-8")])
def test_wkv6_segmented_matches_reference(S, n_seg, hd, log_decay):
    xs = _wkv_inputs(2, S, 2, hd, seed=S + n_seg, log_decay=log_decay)
    _, seg_len, _ = segment_plan(S, n_seg)
    got = wkv6_segmented(*map(torch.from_numpy, xs), n_seg, seg_len)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    js = list(map(jnp.asarray, xs))
    _close(got, ref_wkv6_oracle(*js))
    if log_decay is None:  # fast decays give the reference kernel NaN
        _close(got, ref_wkv6(*js, impl="interpret"))


def test_wkv6_segment_plan_covers_every_length():
    """Segments are whole chunks of at most MAX_SEG_LEN tokens, at most
    MAX_SEGMENTS per round, none of them empty when one round covers the
    sequence; a sequence up to 8 x 128 tokens takes one round, and the
    rounds cover S with less than one round to spare."""
    for S in range(1, 5000):
        n_seg, seg_len, rounds = segment_plan(S)
        assert 1 <= n_seg <= MAX_SEGMENTS
        assert seg_len % SEG_CHUNK == 0 and seg_len <= MAX_SEG_LEN
        assert (rounds - 1) * n_seg * seg_len < S <= rounds * n_seg * seg_len
        assert rounds == 1 if S <= MAX_SEGMENTS * MAX_SEG_LEN else \
            n_seg == MAX_SEGMENTS
        if rounds == 1:
            assert (n_seg - 1) * seg_len < S
