"""The port's mbcodec kernels: plain versions against the reference's
Pallas kernels (interpret mode on the CPU) and the dispatch rules of the
wrappers. The kernels themselves are checked on a CUDA card by
``tests/test_torch_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: decoded atol 1e-5
(atol 1e-3 at QP 5, where a float-order difference can flip one round()
boundary of a ~3e-3 step), bits rtol 1e-4 per block and bytes rtol 1e-3
per frame.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import codec as jc
from repro.kernels.mbcodec import kernel as jk
from repro.kernels.mbcodec import ops as jops
from repro_torch.codec import codec as tc
from repro_torch.kernels import build
from repro_torch.kernels.mbcodec import kernel as tk
from repro_torch.kernels.mbcodec import ops as tops
from repro_torch.kernels.mbcodec.ref import (mbcodec_chunk_ref,
                                             mbcodec_chunk_rowcol,
                                             mbcodec_ref, rowcol_bits,
                                             scores_qp)


def _chunk(T=4, H=32, W=48, seed=3, lo=0.0, hi=1.0, drift=0.04):
    """Drifting scene in [lo, hi] (as ``tests/test_kernels.py::_chunk``)."""
    rng = np.random.RandomState(seed)
    base = lo + (hi - lo) * rng.rand(H, W, 3)
    frames = np.stack([
        np.clip(base + 0.02 * t + drift * rng.randn(H, W, 3), lo, hi)
        for t in range(T)])
    return frames.astype(np.float32)


def _blocks_qp(shape, seed):
    rng = np.random.RandomState(seed)
    blocks = rng.rand(*shape, 16, 16).astype(np.float32)
    qp = rng.uniform(10, 50, shape).astype(np.float32)
    return blocks, qp


@pytest.mark.parametrize("n", [64, 65, 200, 1])
def test_mbcodec_ref_matches_pallas(n):
    blocks, qp = _blocks_qp((n,), n)
    r_pl, b_pl = jops.mbcodec(jnp.asarray(blocks), jnp.asarray(qp),
                              impl="interpret")
    r_t, b_t = mbcodec_ref(torch.from_numpy(blocks), torch.from_numpy(qp))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_pl), atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_pl), rtol=1e-4)


@pytest.mark.parametrize("clip_refs", [False, True])
def test_mbcodec_chunk_ref_matches_pallas_kernel(clip_refs):
    """The block-space scan against ``mbcodec_chunk_pallas`` itself, on
    one 64-block tile: frame t codes blocks[t] - ref and carries ref."""
    blocks, qp = _blocks_qp((5, 64), 11)
    blocks = np.clip(blocks + 0.3 * np.arange(5)[:, None, None, None]
                     - 0.6, 0, 1).astype(np.float32)
    r_pl, b_pl = jk.mbcodec_chunk_pallas(
        jnp.asarray(blocks), jnp.asarray(qp), clip_refs=clip_refs,
        interpret=True)
    r_t, b_t = mbcodec_chunk_ref(torch.from_numpy(blocks),
                                 torch.from_numpy(qp), clip_refs)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_pl), atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_pl), rtol=1e-4)


@pytest.mark.parametrize("clip_refs", [False, True])
@pytest.mark.parametrize("qp", [5.0, 30.0, 50.0])
def test_encode_chunk_fused_matches_pallas(qp, clip_refs):
    """Port ``encode_chunk_fused`` (plain version on CPU) against the
    reference's through its Pallas chunk kernel in interpret mode."""
    frames = _chunk()
    qmap = np.full((1, 2, 3), qp, np.float32)
    d_j, b_j = jops.encode_chunk_fused(jnp.asarray(frames), jnp.asarray(qmap),
                                       clip_refs=clip_refs, impl="interpret")
    d_t, b_t = tops.encode_chunk_fused(torch.from_numpy(frames),
                                       torch.from_numpy(qmap), clip_refs)
    atol = 1e-3 if qp <= 5.0 else 1e-5
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=atol)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-3)


def test_encode_chunk_fused_per_frame_maps_match_pallas():
    """A QP that changes every frame exercises the carried reference."""
    frames = _chunk(T=5)
    qmaps = np.stack([np.full((2, 3), q, np.float32)
                      for q in (30.0, 42.0, 26.0, 50.0, 34.0)])
    for clip_refs in (False, True):
        d_j, b_j = jops.encode_chunk_fused(
            jnp.asarray(frames), jnp.asarray(qmaps), clip_refs=clip_refs,
            impl="interpret")
        d_t, b_t = tops.encode_chunk_fused(
            torch.from_numpy(frames), torch.from_numpy(qmaps), clip_refs)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-3)


@pytest.mark.parametrize("pframe", [False, True])
def test_encode_frame_fused_matches_pallas(pframe):
    H, W = 64, 96
    frames = _chunk(T=2, H=H, W=W)
    qmap = np.random.RandomState(1).uniform(20, 45, (H // 16, W // 16))
    qmap = qmap.astype(np.float32)
    ref = None
    if pframe:
        ref = np.asarray(jc.encode_frame(jnp.asarray(frames[0]),
                                         jnp.asarray(qmap))[0])
    d_j, b_j = jops.encode_frame_fused(
        jnp.asarray(frames[1]), jnp.asarray(qmap), impl="interpret",
        reference=None if ref is None else jnp.asarray(ref))
    d_t, b_t = tops.encode_frame_fused(
        torch.from_numpy(frames[1]), torch.from_numpy(qmap),
        reference=None if ref is None else torch.tensor(ref))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-3)


@pytest.mark.parametrize("maps", ["shared", "per_frame"])
def test_fused_exact_matches_reference_exact_in_gamut(maps):
    """``fused_exact`` carries the exact encoder's semantics: on an
    in-gamut scene it matches the reference's ``exact`` backend."""
    T, H, W = 6, 48, 64
    frames = _chunk(T, H, W, lo=0.1, hi=0.9)
    rng = np.random.RandomState(2)
    qmaps = rng.uniform(24, 44, (1 if maps == "shared" else T, 3, 4))
    qmaps = qmaps.astype(np.float32)
    d_e, b_e = jc.encode_chunk(jnp.asarray(frames), jnp.asarray(qmaps))
    d_t, b_t = tc.CHUNK_ENCODERS["fused_exact"](torch.from_numpy(frames),
                                                torch.from_numpy(qmaps))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_e), atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_e), rtol=1e-3)


def test_cpu_tensors_take_the_plain_version_without_launching():
    frames = torch.from_numpy(_chunk())
    qmap = torch.full((1, 2, 3), 30.0)
    before = dict(tk.LAUNCHES)
    for impl in ("pallas", "fused", "fused_exact"):
        tc.CHUNK_ENCODERS[impl](frames, qmap)
    tops.encode_chunk_fused_scores_batched(
        frames[None], torch.rand(1, 2, 3), torch.tensor([0.5, 30.0, 40.0]))
    assert dict(tk.LAUNCHES) == before


@pytest.mark.parametrize("want_q", [False, True])
def test_plain_versions_return_q_consistent_with_bits(want_q):
    blocks, qp = _blocks_qp((3, 8), 5)
    out = mbcodec_chunk_ref(torch.from_numpy(blocks), torch.from_numpy(qp),
                            want_q=want_q)
    assert len(out) == (3 if want_q else 2)
    if want_q:
        q = out[2]
        assert torch.equal(q, q.round())
        np.testing.assert_allclose(out[1].numpy(),
                                   tc.block_bits(q[:, :, None]).numpy(),
                                   rtol=1e-5)


def test_wrappers_reject_cpu_tensors():
    """A wrapper refuses a tensor it cannot launch on, before building."""
    blocks, qp = _blocks_qp((2, 4), 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.mbcodec_chunk_cuda(torch.from_numpy(blocks), torch.from_numpy(qp))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.mbcodec_frame_cuda(torch.from_numpy(blocks[0]),
                              torch.from_numpy(qp[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.mbcodec_chunk_scores_cuda(
            torch.from_numpy(blocks[None]), torch.zeros(1, 4),
            torch.tensor([0.5, 30.0, 40.0]), 1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["mbcodec"])


def test_chunk_kernel_compiles_in_the_dct_matrix_of_codec_dct():
    """``mbcodec.cu`` writes D out as hex floats so that its transform FMAs
    take D as immediates: bit for bit ``codec/dct.py::dct_matrix()``, which
    the kernel's launch also checks on the card."""
    import re

    from repro_torch.codec.dct import dct_matrix

    src = (build.KERNELS_DIR / build.SOURCES["mbcodec"]).read_text()
    body = src.split("#define MBCODEC_DCT_16")[1].split("}")[0]
    lits = re.findall(r"(-?0x[0-9a-f.]+p[-+]?\d+)f", body)
    table = np.array([float.fromhex(x) for x in lits], np.float32)
    assert table.shape == (256,)
    assert np.array_equal(table.view(np.uint32),
                          dct_matrix().reshape(-1).view(np.uint32))
    assert tk.DCT_MISMATCH == -1 and "kDctMismatch = -1" in src


def test_library_path_tracks_the_source():
    path = build.library_path("mbcodec")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libmbcodec-") and path.suffix == ".so"
    assert (build.KERNELS_DIR / build.SOURCES["mbcodec"]).exists()


# ---------------------------------------------------------------------------
# the scores kernel's plain version (QP thresholded from pooled scores)
# ---------------------------------------------------------------------------
def _pooled(S, n_mb, seed):
    """Dilated-score stand-ins; alpha (0.5) sits exactly on one score of
    every stream, so the ``>=`` of the threshold is exercised."""
    p = np.random.RandomState(seed).rand(S, n_mb).astype(np.float32)
    p[:, 1] = 0.5
    return p


KNOBS = np.array([0.5, 26.0, 44.0], np.float32)


@pytest.mark.parametrize("clip_refs", [False, True])
def test_mbcodec_chunk_scores_ref_matches_pallas_kernel(clip_refs):
    """Block-space scores scan against ``mbcodec_chunk_scores_pallas``
    itself (interpret mode), stream by stream, on one 64-block tile. Seed
    10 is free of round-half flips between the two float orders (seeds 7
    to 9 are not; a flip moves its block by one step)."""
    S, T, N = 2, 5, 64
    rng = np.random.RandomState(10)
    blocks = np.clip(rng.rand(S, T, N, 16, 16)
                     + 0.3 * np.arange(T)[None, :, None, None, None] - 0.6,
                     0, 1).astype(np.float32)
    pooled = _pooled(S, N, 8)
    r_t, b_t = tops.mbcodec_chunk_scores(
        torch.from_numpy(blocks), torch.from_numpy(pooled),
        torch.from_numpy(KNOBS), 1, clip_refs)
    for s in range(S):
        r_pl, b_pl = jk.mbcodec_chunk_scores_pallas(
            jnp.asarray(blocks[s]), jnp.asarray(pooled[s]),
            jnp.asarray(KNOBS), clip_refs=clip_refs, interpret=True)
        np.testing.assert_allclose(r_t[s].numpy(), np.asarray(r_pl),
                                   atol=1e-5)
        np.testing.assert_allclose(b_t[s].numpy(), np.asarray(b_pl),
                                   rtol=1e-4)


@pytest.mark.parametrize("clip_refs", [False, True])
def test_encode_chunk_fused_scores_matches_pallas(clip_refs):
    """The port's scores-path encode (plain version on the CPU) against the
    reference's through its Pallas scores kernel in interpret mode (the
    reference pads to 64-block tiles with -inf scores; the port does not
    pad)."""
    frames = _chunk(T=4, H=48, W=64)
    pooled = _pooled(1, 12, 9).reshape(3, 4)
    d_j, b_j = jops.encode_chunk_fused_scores(
        jnp.asarray(frames), jnp.asarray(pooled), jnp.asarray(KNOBS),
        clip_refs=clip_refs, impl="interpret")
    d_t, b_t = tops.encode_chunk_fused_scores(
        torch.from_numpy(frames), torch.from_numpy(pooled),
        torch.from_numpy(KNOBS), clip_refs)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-3)


@pytest.mark.parametrize("clip_refs", [False, True])
def test_scores_path_equals_explicit_map_path(clip_refs):
    """Scores path and explicit-map path on the implied map are the same
    arithmetic: bit-equal, with alpha exactly on a score (``>=`` takes
    qp_hi there)."""
    frames = torch.from_numpy(_chunk(T=4, H=48, W=64))
    pooled = torch.from_numpy(_pooled(1, 12, 10).reshape(3, 4))
    knobs = torch.from_numpy(KNOBS)
    qmap = torch.where(pooled >= knobs[0], knobs[1], knobs[2])[None]
    assert qmap[0, 0, 1] == 26.0  # the score equal to alpha
    d_s, b_s = tops.encode_chunk_fused_scores(frames, pooled, knobs,
                                              clip_refs)
    d_e, b_e = tops.encode_chunk_fused(frames, qmap, clip_refs)
    assert torch.equal(d_s, d_e) and torch.equal(b_s, b_e)


def test_stream_batched_scores_encode_matches_per_stream():
    """One stream-batched call equals per-stream calls, and extra knobs
    (the controller's drop threshold) are ignored."""
    frames = torch.from_numpy(np.stack([_chunk(T=3, H=32, W=48, seed=s)
                                        for s in (1, 2, 3)]))
    pooled = torch.from_numpy(_pooled(3, 6, 11).reshape(3, 2, 3))
    knobs = torch.tensor([0.5, 26.0, 44.0, 0.02])
    for clip_refs in (False, True):
        dec, pbytes = tops.encode_chunk_fused_scores_batched(
            frames, pooled, knobs, clip_refs)
        assert tuple(dec.shape) == tuple(frames.shape)
        assert tuple(pbytes.shape) == (3, 3)
        for s in range(3):
            d_i, b_i = tops.encode_chunk_fused_scores(frames[s], pooled[s],
                                                      knobs[:3], clip_refs)
            assert torch.equal(dec[s], d_i) and torch.equal(pbytes[s], b_i)


def test_scores_qp_thresholds_with_ge():
    from repro_torch.kernels.mbcodec.ref import scores_qp

    pooled = torch.tensor([[0.2, 0.5, 0.7]])
    qp = scores_qp(pooled, torch.tensor([0.5, 30.0, 40.0]), 2)
    assert qp.tolist() == [[40.0, 40.0, 30.0, 30.0, 30.0, 30.0]]


# ---------------------------------------------------------------------------
# the plain twin of the chunk kernel's association (row pass, column pass,
# quantize, D^T deq, then D; bits summed per column, then a butterfly)
# ---------------------------------------------------------------------------
def _assert_flips_bounded(got, want):
    """got / want = (rec, bits, q) with a leading frame axis: flipped
    coefficients at most 1e-4 of all; blocks without flips agree, decoded
    atol 1e-5 and bits rtol 1e-4. Returns the number of flips."""
    flips = got[2] != want[2]
    n_flips = int(flips.sum())
    assert n_flips <= 1e-4 * flips.numel()
    clean = ~flips.flatten(2).any(-1).any(0)  # blocks never flipped
    assert bool(clean.any())
    np.testing.assert_allclose(got[0][:, clean].numpy(),
                               want[0][:, clean].numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1][:, clean].numpy(),
                               want[1][:, clean].numpy(), rtol=1e-4)
    return n_flips


def _drifting_blocks(shape, seed):
    """Blocks (T, ..., 16, 16) in [0, 1] that drift frame to frame, so the
    carried reference matters."""
    rng = np.random.RandomState(seed)
    T = shape[0]
    ramp = 0.3 * np.arange(T).reshape((T,) + (1,) * (len(shape) + 1))
    return np.clip(rng.rand(*shape, 16, 16) + ramp - 0.6, 0,
                   1).astype(np.float32)


@pytest.mark.parametrize("clip_refs", [False, True])
@pytest.mark.parametrize("T,N,seed", [(5, 64, 11), (1, 21, 4), (10, 21, 6)])
def test_rowcol_twin_matches_plain_version(T, N, seed, clip_refs):
    """The twin against ``mbcodec_chunk_ref`` (the ref's association, D X
    then D^T), flips counted, with q consistent with the bits."""
    blocks = _drifting_blocks((T, N), seed)
    qp = np.random.RandomState(seed + 1).uniform(10, 50, (T, N))
    args = (torch.from_numpy(blocks), torch.from_numpy(qp.astype(np.float32)),
            clip_refs)
    got = mbcodec_chunk_rowcol(*args, want_q=True)
    want = mbcodec_chunk_ref(*args, want_q=True)
    _assert_flips_bounded(got, want)
    assert torch.equal(got[2], got[2].round())
    assert all(torch.isfinite(t).all() for t in got)
    # torch's CPU log2 may differ by a few ulp on a process's first call,
    # so the bits of a second call are held to rounding, not to the bit
    rec, bits = mbcodec_chunk_rowcol(*args)
    assert torch.equal(rec, got[0])
    np.testing.assert_allclose(bits.numpy(), got[1].numpy(), rtol=1e-6)


@pytest.mark.parametrize("clip_refs", [False, True])
def test_rowcol_twin_matches_pallas_chunk_kernel(clip_refs):
    """The twin against ``mbcodec_chunk_pallas`` itself (interpret mode) on
    one 64-block tile, the reference's q recovered from its ``want_q``-free
    outputs by the plain version (flips between the two float orders
    counted against the plain version's q)."""
    blocks = _drifting_blocks((5, 64), 11)
    qp = np.random.RandomState(12).uniform(10, 50, (5, 64)).astype(
        np.float32)
    r_pl, b_pl = jk.mbcodec_chunk_pallas(
        jnp.asarray(blocks), jnp.asarray(qp), clip_refs=clip_refs,
        interpret=True)
    args = (torch.from_numpy(blocks), torch.from_numpy(qp), clip_refs)
    got = mbcodec_chunk_rowcol(*args, want_q=True)
    q_plain = mbcodec_chunk_ref(*args, want_q=True)[2]
    _assert_flips_bounded(got, (torch.from_numpy(np.asarray(r_pl)),
                                torch.from_numpy(np.asarray(b_pl)), q_plain))


@pytest.mark.parametrize("clip_refs", [False, True])
def test_rowcol_twin_matches_pallas_scores_kernel(clip_refs):
    """The twin on the QP map ``scores_qp`` implies, against
    ``mbcodec_chunk_scores_pallas`` (interpret mode), stream by stream;
    alpha sits exactly on one score of each stream."""
    S, T, N = 2, 5, 64
    blocks = _drifting_blocks((T, S, N), 10)
    pooled = _pooled(S, N, 8)
    qp = scores_qp(torch.from_numpy(pooled), torch.from_numpy(KNOBS), 1)
    args = (torch.from_numpy(blocks), qp[None].expand(T, S, N), clip_refs)
    got = mbcodec_chunk_rowcol(*args, want_q=True)
    q_plain = mbcodec_chunk_ref(*args, want_q=True)[2]
    for s in range(S):
        r_pl, b_pl = jk.mbcodec_chunk_scores_pallas(
            jnp.asarray(blocks[:, s]), jnp.asarray(pooled[s]),
            jnp.asarray(KNOBS), clip_refs=clip_refs, interpret=True)
        _assert_flips_bounded(
            tuple(t[:, s] for t in got),
            (torch.from_numpy(np.asarray(r_pl)),
             torch.from_numpy(np.asarray(b_pl)), q_plain[:, s]))


def test_rowcol_bits_sum_columns_then_by_butterfly():
    """``rowcol_bits`` adds each column from row 0 down, then the column
    sums pairwise at distance 8, 4, 2, 1 (the kernel's shuffle order), then
    the header: equal to an explicit float32 loop, bit for bit."""
    cost = torch.from_numpy(np.random.RandomState(3).rand(4, 16, 16)
                            .astype(np.float32) * 20)
    bits = rowcol_bits(cost)
    for n in range(4):
        col = [torch.tensor(0.0) for _ in range(16)]
        for i in range(16):
            for k in range(16):
                col[i] = col[i] + cost[n, k, i]
        for half in (8, 4, 2, 1):
            col = [col[i] + col[i + half] for i in range(half)]
        assert float(bits[n]) == float(col[0] + tc.BLOCK_OVERHEAD)


def test_rowcol_twin_bits_agree_with_block_bits_of_its_q():
    blocks = _drifting_blocks((2, 3), 2)
    _, bits, q = mbcodec_chunk_rowcol(torch.from_numpy(blocks),
                                      torch.full((2, 3), 12.0), want_q=True)
    np.testing.assert_allclose(bits.numpy(),
                               tc.block_bits(q[:, :, None]).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("n", [1, 64, 65, 200])
def test_rowcol_twin_matches_pallas_frame_kernel(n):
    """The frame kernel is the chunk kernel at T = 1 with no clip, so its
    association is the twin's at T = 1: held against ``mbcodec_pallas``
    itself (interpret mode), flips counted against the plain version's q."""
    blocks, qp = _blocks_qp((n,), n)
    r_pl, b_pl = jops.mbcodec(jnp.asarray(blocks), jnp.asarray(qp),
                              impl="interpret")
    args = (torch.from_numpy(blocks)[None], torch.from_numpy(qp)[None])
    got = mbcodec_chunk_rowcol(*args, False, want_q=True)
    q_plain = mbcodec_ref(*(a[0] for a in args), want_q=True)[2]
    _assert_flips_bounded(got, (torch.from_numpy(np.asarray(r_pl))[None],
                                torch.from_numpy(np.asarray(b_pl))[None],
                                q_plain[None]))


def test_mbcodec_source_holds_one_kernel_template():
    """``mbcodec.cu`` holds one ``__global__`` template, which serves the
    frame, chunk and scores entry points; the frame's own body is gone."""
    src = (build.KERNELS_DIR / build.SOURCES["mbcodec"]).read_text()
    assert src.count("__global__") == 1
    assert "mbcodec_frame_kernel" not in src
    for entry in ("mbcodec_frame", "mbcodec_chunk", "mbcodec_chunk_scores"):
        assert f'extern "C" int {entry}(' in src
