"""Parity of the port's codec (``repro_torch.codec``) with the reference
(``repro.codec``) on the CPU: the same numpy inputs go through both.

Tolerances: decoded pixels atol 1e-5 (float32 transform round-off, well
under one 8-bit level) and bytes rtol 1e-3, the bounds of
``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import codec as jc
from repro.codec import dct as jd
from repro_torch.codec import codec as tc
from repro_torch.codec import dct as td

DEC_ATOL, BYTES_RTOL = 1e-5, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls: the suite's
    workers share the machine's cores, and torch's default of a thread
    per core makes these small eager ops wait on each other's spinning
    pools (tens of times slower under the full suite). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(T=4, H=32, W=48, seed=3, lo=0.0, hi=1.0, drift=0.04):
    """Drifting scene in [lo, hi]: consecutive frames differ enough that
    the P-frame reference chain matters. lo/hi inside (0, 1) keep every
    reconstruction in gamut."""
    rng = np.random.RandomState(seed)
    base = lo + (hi - lo) * rng.rand(H, W, 3)
    frames = np.stack([
        np.clip(base + 0.02 * t + drift * rng.randn(H, W, 3), lo, hi)
        for t in range(T)])
    return frames.astype(np.float32)


def _two_level_map(H, W, qp_hi=30.0, qp_lo=42.0):
    mb = np.indices((H // 16, W // 16)).sum(0) % 2
    return np.where(mb, qp_hi, qp_lo).astype(np.float32)


def _per_frame_maps(T, H, W, seed=7):
    rng = np.random.RandomState(seed)
    return rng.uniform(20, 45, (T, H // 16, W // 16)).astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(torch.tensor(a) for a in arrays), **kw)
    return ([np.asarray(o) for o in out_j], [o.numpy() for o in out_t])


def _assert_codec_close(got, want, dec_atol=DEC_ATOL):
    np.testing.assert_allclose(got[0], want[0], atol=dec_atol)
    np.testing.assert_allclose(got[1], want[1], rtol=BYTES_RTOL)


def test_transform_constants_identical():
    np.testing.assert_array_equal(td.dct_matrix(), jd.dct_matrix())
    np.testing.assert_array_equal(td.freq_weight(), jd.freq_weight())
    qp = np.arange(0, 52, dtype=np.float32)
    # XLA rewrites the reference's exp2((qp-4)/6) * 0.625/255 as
    # exp((qp-4) * ln2/6) * const; the port evaluates the formula as
    # written, so the two steps differ by up to 4 float32 ulp
    np.testing.assert_allclose(td.qstep(torch.from_numpy(qp)).numpy(),
                               np.asarray(jd.qstep(jnp.asarray(qp))),
                               rtol=5e-7)


@pytest.mark.parametrize("shape", [(32, 48, 3), (2, 16, 64, 3)])
def test_blockify_layout_identical(shape):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    jb = jd.blockify if len(shape) == 3 else \
        (lambda a: jnp.stack([jd.blockify(f) for f in a]))
    got = td.blockify(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jb(jnp.asarray(x))))
    back = td.unblockify(torch.from_numpy(got), *shape[-3:-1]).numpy()
    np.testing.assert_array_equal(back, x)


def test_dct_pair_matches():
    x = np.random.RandomState(1).rand(5, 3, 16, 16).astype(np.float32)
    c_t = td.dct2(torch.from_numpy(x))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(jd.dct2(x)),
                               atol=1e-5)
    np.testing.assert_allclose(td.idct2(c_t).numpy(), x, atol=1e-5)


@pytest.mark.parametrize("pframe", [False, True])
def test_encode_frame_matches(pframe):
    f = _frames(T=2, H=64, W=96)
    qmap = _per_frame_maps(1, 64, 96)[0]
    if pframe:
        ref_dec, _ = jc.encode_frame(jnp.asarray(f[0]), jnp.asarray(qmap))
        ref = np.asarray(ref_dec)
        got_j, got_t = _both(lambda a, q, r: jc.encode_frame(a, q, r),
                             lambda a, q, r: tc.encode_frame(a, q, r),
                             f[1], qmap, ref)
    else:
        got_j, got_t = _both(jc.encode_frame, tc.encode_frame, f[0], qmap)
    _assert_codec_close(got_t, got_j)


@pytest.mark.parametrize("maps", ["shared", "per_frame"])
def test_encode_chunk_exact_matches(maps):
    T, H, W = 5, 48, 64
    frames = _frames(T, H, W)
    qmaps = _two_level_map(H, W)[None] if maps == "shared" \
        else _per_frame_maps(T, H, W)
    _assert_codec_close(*_both(jc.encode_chunk, tc.encode_chunk, frames,
                               qmaps)[::-1])


@pytest.mark.parametrize("maps", ["shared", "per_frame"])
def test_encode_chunk_fast_matches(maps):
    T, H, W = 5, 48, 64
    frames = _frames(T, H, W)
    qmaps = _two_level_map(H, W)[None] if maps == "shared" \
        else _per_frame_maps(T, H, W)
    _assert_codec_close(*_both(jc.encode_chunk_fast, tc.encode_chunk_fast,
                               frames, qmaps)[::-1])


@pytest.mark.parametrize("maps", ["shared", "per_frame"])
def test_fast_exact_matches_reference_exact_in_gamut(maps):
    """The port's clip-corrected fast scan against the reference's exact
    encoder on an in-gamut scene (the reference's own fast_exact is not
    the oracle: it drifts from exact on saturating content)."""
    T, H, W = 6, 48, 64
    frames = _frames(T, H, W, lo=0.1, hi=0.9)
    qmaps = _two_level_map(H, W)[None] if maps == "shared" \
        else _per_frame_maps(T, H, W)
    want = [np.asarray(o) for o in
            jc.encode_chunk(jnp.asarray(frames), jnp.asarray(qmaps))]
    got = [o.numpy() for o in tc.encode_chunk_fast(
        torch.from_numpy(frames), torch.from_numpy(qmaps),
        clip_correct=True)]
    _assert_codec_close(got, want)


def test_fast_exact_clips_like_exact_on_saturating_scene():
    """On saturating content the unconditional clip correction keeps the
    port's fast_exact on the port's exact encoder (the same semantics)."""
    T, H, W = 5, 32, 48
    frames = torch.from_numpy(_frames(T, H, W))
    qmaps = torch.from_numpy(_two_level_map(H, W)[None])
    want = tc.encode_chunk(frames, qmaps)
    got = tc.encode_chunk_fast(frames, qmaps, clip_correct=True)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               atol=DEC_ATOL)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(),
                               rtol=BYTES_RTOL)


@pytest.mark.parametrize("qp", [24, 36])
def test_encode_chunk_uniform_matches(qp):
    frames = _frames(4, 32, 48)
    want = [np.asarray(o) for o in
            jc.encode_chunk_uniform(jnp.asarray(frames), qp)]
    got = [o.numpy() for o in
           tc.encode_chunk_uniform(torch.from_numpy(frames), qp)]
    _assert_codec_close(got, want)


def test_block_bits_and_roi_map_match():
    q = np.random.RandomState(4).randint(-6, 7, (7, 3, 16, 16))
    q = q.astype(np.float32)
    np.testing.assert_allclose(
        tc.block_bits(torch.from_numpy(q)).numpy(),
        np.asarray(jc.block_bits(jnp.asarray(q))), rtol=1e-5)  # sum order
    mask = np.random.RandomState(5).rand(3, 4) > 0.5
    np.testing.assert_array_equal(
        tc.roi_qp_map(torch.from_numpy(mask), 30, 42).numpy(),
        np.asarray(jc.roi_qp_map(jnp.asarray(mask), 30, 42)))


def test_registry_has_the_reference_backends():
    assert tc.CHUNK_ENCODERS.names() == sorted(jc.CHUNK_ENCODERS.names())
    assert len(tc.CHUNK_ENCODERS) == 6 and "fused" in tc.CHUNK_ENCODERS
    with pytest.raises(ValueError, match="registered backends"):
        tc.CHUNK_ENCODERS.resolve("nope")
    with pytest.raises(ValueError, match="already registered"):
        tc.CHUNK_ENCODERS.register("exact", tc.encode_chunk)


@pytest.mark.parametrize("impl", ["exact", "fast", "fast_exact", "pallas",
                                  "fused", "fused_exact"])
def test_registry_backend_matches_reference_backend(impl):
    """Each registered backend against the reference backend of the same
    name, where that reference backend is an oracle on this scene: the
    reference's pallas / fused_exact run its exact semantics, fused its
    fast semantics, all on in-gamut content."""
    T, H, W = 4, 32, 48
    frames = _frames(T, H, W, lo=0.1, hi=0.9)
    qmaps = _two_level_map(H, W)[None]
    oracle = {"pallas": "exact", "fused": "fast",
              "fused_exact": "exact"}.get(impl, impl)
    want = [np.asarray(o) for o in jc.CHUNK_ENCODERS[oracle](
        jnp.asarray(frames), jnp.asarray(qmaps))]
    got = [o.numpy() for o in tc.CHUNK_ENCODERS[impl](
        torch.from_numpy(frames), torch.from_numpy(qmaps))]
    _assert_codec_close(got, want)
