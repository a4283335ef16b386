"""``decode_attn`` on the int8 KV cache, on the CPU.

The CUDA kernel reads the int8 form ``{"q": int8, "s": fp32 (..., 1)}``
with its own arithmetic: an int8 value made fp32 by a byte permute into
the mantissa of 2^23 and a subtraction, the fp32 product with the scale,
then, for a bf16 q, the packed round-to-nearest-even cast. Its plain twin,
``ref.py::dequantize_bits``, does the same in int32 bits, and must equal
``cache_read(c, T)`` bit for bit: that is what keeps the kernel within the
attention bound of the plain version (its card tests are in
``tests/test_torch_cuda.py``). Here the twin meets ``cache_read`` on every
int8 value against scales across ``quantize_kv``'s range, and on scales
whose bf16 rounding is an exact tie; and the port's plain int8 attention
meets the reference's int8 cache (``quantize_kv`` and ``cache_read``) read
by its Pallas kernel in interpret mode, within the reference's kernel
bound (atol 1e-5, rtol 1e-4: both sides attend over the same dequantized
values, in other summation orders).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attn as ref_decode_attn
from repro.models import layers as RL
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import dequantize_bits
from repro_torch.models.layers import cache_read, quantize_kv

ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
VALUES = np.arange(-127, 128, dtype=np.int8)  # all that quantize_kv writes
# quantize_kv's scales: max(absmax, 1e-8) / 127, absmax from 0 to 1e6
SMALLEST_SCALE = np.float32(1e-8) / np.float32(127)
LARGEST_SCALE = np.float32(1e6) / np.float32(127)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the machine's cores.
    Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    """A tensor's bit patterns, for comparisons that tell -0 from 0."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _form(scales):
    """Every int8 value against every scale, as the cache's form (255,
    n, 1)."""
    n = scales.size
    q = torch.from_numpy(np.repeat(VALUES[:, None], n, 1))[..., None]
    s = torch.from_numpy(np.broadcast_to(scales, (VALUES.size, n)).copy())
    return {"q": q.contiguous(), "s": s[..., None].contiguous()}


def _tie_scales(n, seed):
    """fp32 scales whose low 16 bits are exactly 0x8000: times 1, 2 or 64
    (exact) each product is a tie for the bf16 rounding; bit 16 even and
    odd alike, exponents across quantize_kv's range."""
    rng = np.random.default_rng(seed)
    lo = int(np.float32(SMALLEST_SCALE).view(np.uint32))
    hi = int(np.float32(LARGEST_SCALE).view(np.uint32))
    top = rng.integers(lo >> 16, hi >> 16, n, dtype=np.uint32)
    top[: n // 2] &= ~np.uint32(1)  # even: the tie rounds down
    top[n // 2:] |= np.uint32(1)    # odd: the tie rounds up
    return ((top << np.uint32(16)) | np.uint32(0x8000)).view(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_twin_equals_cache_read_on_every_value(dtype):
    """All 255 int8 values against 2^12 scales drawn log-uniformly across
    quantize_kv's range, its smallest scale and the largest: the twin of
    the kernel's arithmetic equals ``cache_read`` bit for bit."""
    rng = np.random.default_rng(0)
    scales = np.exp2(rng.uniform(np.log2(SMALLEST_SCALE),
                                 np.log2(LARGEST_SCALE), 4096))
    scales = np.concatenate([scales.astype(np.float32),
                             [SMALLEST_SCALE, LARGEST_SCALE]])
    c = _form(scales.astype(np.float32))
    got = dequantize_bits(c, dtype)
    assert got.dtype == dtype and got.shape == c["q"].shape
    assert torch.equal(_bits(got), _bits(cache_read(c, dtype)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_twin_rounds_ties_to_even(dtype):
    """Scales whose product with +-1, +-2 and +-64 is an exact bf16 tie:
    those round to the even neighbour, up as often as down, and the twin
    equals ``cache_read`` on them and on every other value."""
    scales = _tie_scales(512, seed=1)
    c = _form(scales)
    got, want = dequantize_bits(c, dtype), cache_read(c, dtype)
    assert torch.equal(_bits(got), _bits(want))
    exact = torch.from_numpy(VALUES.astype(np.float32))[:, None, None] \
        * torch.from_numpy(scales)[None, :, None]
    ties = torch.from_numpy(np.isin(VALUES, [-64, -2, -1, 1, 2, 64]))
    assert bool(((exact[ties].view(torch.int32) & 0xFFFF) == 0x8000).all())
    if dtype == torch.bfloat16:  # half the ties round up in magnitude
        up = got[ties].float().abs() > exact[ties].abs()
        assert 0.4 < float(up.float().mean()) < 0.6


def test_dequantize_twin_takes_bf16_or_fp32_only():
    c = _form(np.float32([0.5]))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        dequantize_bits(c, torch.float16)


@pytest.mark.parametrize("dims", [(2, 384, 4, 1, 80),   # stablelm's G=1
                                  (2, 384, 2, 3, 80),
                                  (2, 384, 2, 3, 64),   # smollm's G=3
                                  (2, 384, 4, 1, 128),  # moonshot's G=1
                                  (1, 384, 2, 8, 128)])  # qwen's G=8
@pytest.mark.parametrize("pos", [0, 200, 383])  # first, inside a tile, last
@pytest.mark.parametrize("bf16", [True, False])
def test_plain_int8_attention_matches_reference(dims, pos, bf16):
    """The port's plain version on the int8 form against the reference's
    int8 cache read by its Pallas kernel in interpret mode, on the same
    numpy inputs (the two quantize_kv agree value for value)."""
    B, S, KV, G, hd = dims
    rng = np.random.default_rng(S + G + hd)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((B, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    if bf16:  # the same bf16 q on both sides
        q = q.astype(ml_dtypes.bfloat16)
    dtype, jdtype = ((torch.bfloat16, jnp.bfloat16) if bf16
                     else (torch.float32, jnp.float32))
    tq = torch.from_numpy(q.astype(np.float32)).to(dtype)
    tk, tv = (quantize_kv(torch.from_numpy(a)) for a in (k, v))
    jk, jv = (RL.quantize_kv(jnp.asarray(a)) for a in (k, v))
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
        np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))
    got = decode_attn(tq, tk, tv, pos)
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, hd)
    want = ref_decode_attn(jnp.asarray(q), RL.cache_read(jk, jdtype),
                           RL.cache_read(jv, jdtype), pos, impl="interpret",
                           blk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)

