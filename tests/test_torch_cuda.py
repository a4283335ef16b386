"""The port's CUDA kernels on a card, against their plain versions.

This file imports no JAX, so it runs on a CUDA host without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Elsewhere every test skips. Tolerances: decoded atol 1e-5 and bits rtol
1e-4 in blocks where no quantized coefficient flips; round-half flips
between the kernel's and cuBLAS's float orders at most 1e-4 of the
coefficients (the same against the chunk kernel's row/column twin,
``ref.py::mbcodec_chunk_rowcol``, which differs from it by FMA rounding
only); through the codec backends, where a flip moves its
macroblock for the rest of the chunk, at most 2 of 60 macroblocks off by
more than 1e-5; bytes per frame rtol 1e-3. The scores kernel against the
explicit-array kernel fed the implied QP map, and the frame wrapper
against the chunk kernel at T = 1: bit-equal (one kernel body); each
entry point against itself, called again or replayed from a CUDA graph:
bit-equal (no atomics). ``accgrad_reduce`` against its plain version:
rtol 1e-5 per macroblock sum (summation order only); batched against per
frame: bit-equal (each macroblock is summed alike). ``accgrad_frames`` on
the card against the CPU's plain path: atol 1e-4 on grids normalised to
[0, 1], since cuDNN's convolutions sum in other orders than the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.codec import codec as tc
from repro_torch.kernels.mbcodec import kernel as tk
from repro_torch.kernels.mbcodec import ops as tops
from repro_torch.kernels.mbcodec.ref import (mbcodec_chunk_ref,
                                             mbcodec_chunk_rowcol,
                                             mbcodec_chunk_scores_ref,
                                             mbcodec_ref, scores_qp)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _frames(T=10, H=96, W=160, seed=3):
    rng = np.random.RandomState(seed)
    base = rng.rand(H, W, 3)
    return np.stack([np.clip(base + 0.02 * t + 0.04 * rng.randn(H, W, 3),
                             0, 1) for t in range(T)]).astype(np.float32)


def _blocks_qp(cuda):
    frames = torch.from_numpy(_frames()).to(cuda)
    blocks, _, _ = tops._chunk_blocks(frames)
    qp = np.random.RandomState(0).uniform(20, 45, blocks.shape[:2])
    return blocks, torch.from_numpy(qp.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("variant", ["frame", "chunk", "chunk_clip"])
def test_kernel_matches_plain_version(cuda, variant):
    blocks, qp = _blocks_qp(cuda)
    if variant == "frame":
        got = tk.mbcodec_frame_cuda(blocks[0].contiguous(),
                                    qp[0].contiguous(), want_q=True)
        want = mbcodec_ref(blocks[0], qp[0], want_q=True)
        got, want = ([t[None] for t in out] for out in (got, want))
    else:
        clip = variant == "chunk_clip"
        got = tk.mbcodec_chunk_cuda(blocks, qp, clip, want_q=True)
        want = mbcodec_chunk_ref(blocks, qp, clip, want_q=True)
    torch.cuda.synchronize()
    flips = got[2] != want[2]
    assert flips.sum().item() <= 1e-4 * flips.numel()
    clean = ~flips.flatten(2).any(-1).any(0)  # blocks never flipped
    np.testing.assert_allclose(got[0][:, clean].cpu().numpy(),
                               want[0][:, clean].cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1][:, clean].cpu().numpy(),
                               want[1][:, clean].cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("impl,oracle", [("pallas", "exact"),
                                         ("fused", "fast"),
                                         ("fused_exact", "exact")])
def test_kernel_backends_match_their_semantics(cuda, impl, oracle):
    """Each kernel backend against the plain backend with its semantics,
    all on the card; the launch counter moves for the kernel only. A
    round-half flip moves its macroblock for the rest of the chunk, so
    decoded pixels agree within 1e-5 in all but at most 2 of the 60
    macroblocks; bytes per frame within rtol 1e-3."""
    T, H, W = 10, 96, 160
    frames = torch.from_numpy(_frames(T, H, W)).to(cuda)
    qmap = torch.from_numpy(np.random.RandomState(1).uniform(
        24, 44, (1, H // 16, W // 16)).astype(np.float32)).to(cuda)
    d_o, b_o = tc.CHUNK_ENCODERS[oracle](frames, qmap)
    before = sum(tk.LAUNCHES.values())
    d_k, b_k = tc.CHUNK_ENCODERS[impl](frames, qmap)
    torch.cuda.synchronize()
    assert sum(tk.LAUNCHES.values()) - before == (T if impl == "pallas"
                                                  else 1)
    assert d_k.shape == frames.shape and torch.isfinite(d_k).all()
    per_mb = (d_k - d_o).abs().reshape(T, H // 16, 16, W // 16, 16, 3)
    per_mb = per_mb.amax(dim=(0, 2, 4, 5))
    assert int((per_mb > 1e-5).sum()) <= 2
    np.testing.assert_allclose(b_k.cpu().numpy(), b_o.cpu().numpy(),
                               rtol=1e-3)


def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    blocks, qp = _blocks_qp(cuda)
    with pytest.raises(ValueError, match="float32"):
        tk.mbcodec_chunk_cuda(blocks.double(), qp)
    with pytest.raises(ValueError, match="shape"):
        tk.mbcodec_chunk_cuda(blocks, qp[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tk.mbcodec_chunk_cuda(blocks.transpose(2, 3), qp)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.mbcodec_frame_cuda(blocks[0].contiguous(), qp[0].cpu())
    knobs = torch.tensor([0.5, 30.0, 40.0], device=cuda)
    pooled = torch.rand(1, blocks.shape[1] // 3, device=cuda)
    with pytest.raises(ValueError, match="whole macroblocks"):
        tk.mbcodec_chunk_scores_cuda(blocks[None], pooled, knobs, 7)
    with pytest.raises(ValueError, match="shape"):
        tk.mbcodec_chunk_scores_cuda(blocks[None], pooled, knobs[:2], 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.mbcodec_chunk_scores_cuda(blocks[None], pooled, knobs.cpu(), 3)


def _fleet_blocks(cuda, S=3):
    frames = torch.from_numpy(np.stack([_frames(seed=s) for s in range(S)]))
    blocks, n_mb, C = tops._chunk_blocks(frames.to(cuda))
    pooled = np.random.RandomState(5).rand(S, n_mb).astype(np.float32)
    pooled[:, 7] = 0.5  # alpha exactly on a score
    return blocks, torch.from_numpy(pooled).to(cuda), C


@pytest.mark.parametrize("clip", [False, True])
def test_scores_kernel_matches_plain_and_explicit_kernel(cuda, clip):
    """One stream-batched launch against its plain version (flips
    counted) and, bit for bit, against the explicit-array kernel per
    stream on the implied QP map; the knobs stay on the card."""
    blocks, pooled, C = _fleet_blocks(cuda)
    knobs = torch.tensor([0.5, 28.0, 42.0], device=cuda)
    before = dict(tk.LAUNCHES)
    got = tk.mbcodec_chunk_scores_cuda(blocks, pooled, knobs, C, clip,
                                       want_q=True)
    assert tk.LAUNCHES[tk.scores_kernel_name(clip)] \
        == before.get(tk.scores_kernel_name(clip), 0) + 1
    want = mbcodec_chunk_scores_ref(blocks, pooled, knobs, C, clip,
                                    want_q=True)
    torch.cuda.synchronize()
    S, T, N = blocks.shape[:3]
    flips = got[2] != want[2]
    assert flips.sum().item() <= 1e-4 * flips.numel()
    clean = ~flips.flatten(3).any(-1).any(1)  # (S, N) never flipped
    for s in range(S):
        np.testing.assert_allclose(got[0][s][:, clean[s]].cpu().numpy(),
                                   want[0][s][:, clean[s]].cpu().numpy(),
                                   atol=1e-5)
        qp = scores_qp(pooled[s:s + 1], knobs, C)[0]
        assert qp[7 * C] == 28.0
        exp = tk.mbcodec_chunk_cuda(blocks[s].contiguous(),
                                    qp.expand(T, N).contiguous(), clip,
                                    want_q=True)
        for a, b in zip(got, exp):
            assert torch.equal(a[s], b)


# The chunk kernel takes 8 blocks per thread block (2 a warp, a row per
# thread): N = 3 x 7 = 21 leaves a ragged last thread block of 5.
RAGGED_MB, RAGGED_C = 7, 3


def _ragged_blocks(cuda, S, T, seed):
    """Blocks (S, T, 21, 16, 16) in [0, 1] drifting frame to frame, and
    QP (S, T, 21) uniform in [10, 50]."""
    rng = np.random.RandomState(seed)
    N = RAGGED_MB * RAGGED_C
    ramp = 0.3 * np.arange(T).reshape(1, T, 1, 1, 1)
    blocks = np.clip(rng.rand(S, T, N, 16, 16) + ramp - 0.6, 0, 1)
    qp = rng.uniform(10, 50, (S, T, N))
    return (torch.from_numpy(blocks.astype(np.float32)).to(cuda),
            torch.from_numpy(qp.astype(np.float32)).to(cuda))


def _assert_flips_bounded(got, want):
    """got / want = (rec, bits, q), frames first: flips at most 1e-4 of
    the coefficients, and blocks without flips within decoded atol 1e-5
    and bits rtol 1e-4."""
    flips = got[2] != want[2]
    assert flips.sum().item() <= 1e-4 * flips.numel()
    clean = ~flips.flatten(2).any(-1).any(0)
    assert bool(clean.any())
    np.testing.assert_allclose(got[0][:, clean].cpu().numpy(),
                               want[0][:, clean].cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1][:, clean].cpu().numpy(),
                               want[1][:, clean].cpu().numpy(), rtol=1e-4)


def _frame_as_chunk(blocks, qp, clip=False, want_q=False):
    """The frame wrapper on a chunk of one frame, with no clip (the chunk
    kernel at T = 1), results with their leading frame axis."""
    assert blocks.shape[0] == 1 and not clip
    out = tk.mbcodec_frame_cuda(blocks[0], qp[0], want_q=want_q)
    return tuple(t[None] for t in out)


def _frame_ref(blocks, qp, clip=False, want_q=False):
    """``mbcodec_ref`` on a chunk of one frame, as ``_frame_as_chunk``."""
    assert blocks.shape[0] == 1 and not clip
    return tuple(t[None] for t in mbcodec_ref(blocks[0], qp[0], want_q))


# (T, clip, entry point); the chunk cases keep their ids, and the frame
# wrapper runs at the one shape it takes (T = 1, no clip)
RAGGED_CASES = [pytest.param(T, clip, "chunk", id=f"{T}-{clip}")
                for T in (1, 10) for clip in (False, True)] + [
    pytest.param(1, False, "frame", id="frame")]


@pytest.mark.parametrize("T,clip,entry", RAGGED_CASES)
def test_chunk_kernel_on_a_ragged_grid_matches_plain_and_twin(cuda, T,
                                                              clip, entry):
    """The explicit-QP chunk kernel (or the frame wrapper) at N = 21 (a
    ragged last thread block) against the plain version and against its
    row/column twin."""
    blocks, qp = _ragged_blocks(cuda, 1, T, 20 + T)
    kernel, plain = ((tk.mbcodec_chunk_cuda, mbcodec_chunk_ref)
                     if entry == "chunk" else (_frame_as_chunk, _frame_ref))
    got = kernel(blocks[0], qp[0], clip, want_q=True)
    for oracle in (plain, mbcodec_chunk_rowcol):
        want = oracle(blocks[0], qp[0], clip, want_q=True)
        torch.cuda.synchronize()
        _assert_flips_bounded(got, want)


def test_frame_kernel_is_the_chunk_kernel_at_one_frame(cuda):
    """The frame wrapper launches the chunk kernel at T = 1 with no clip:
    bit for bit ``mbcodec_chunk_cuda`` on the same frame, q included."""
    blocks, qp = _blocks_qp(cuda)
    before = dict(tk.LAUNCHES)
    got = _frame_as_chunk(blocks[:1], qp[:1], want_q=True)
    assert tk.LAUNCHES["mbcodec_frame"] == before.get("mbcodec_frame",
                                                      0) + 1
    want = tk.mbcodec_chunk_cuda(blocks[:1], qp[:1], False, want_q=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("T", [1, 10])
@pytest.mark.parametrize("S", [1, 3])
def test_scores_kernel_on_a_ragged_grid_matches_plain_twin_and_explicit(
        cuda, S, T, clip):
    """The scores kernel at N = 21 over S streams against the plain
    version and the twin on the implied QP map (flips counted), and bit
    for bit against the explicit-QP kernel fed that map."""
    blocks, _ = _ragged_blocks(cuda, S, T, 30 + S + T)
    pooled = torch.from_numpy(np.random.RandomState(S).rand(
        S, RAGGED_MB).astype(np.float32)).to(cuda)
    pooled[:, 2] = 0.5  # alpha exactly on a score
    knobs = torch.tensor([0.5, 24.0, 40.0], device=cuda)
    got = tk.mbcodec_chunk_scores_cuda(blocks, pooled, knobs, RAGGED_C,
                                       clip, want_q=True)
    qp = scores_qp(pooled, knobs, RAGGED_C)  # (S, N)
    N = qp.shape[1]
    for s in range(S):
        mine = tuple(t[s] for t in got)
        for oracle in (mbcodec_chunk_ref, mbcodec_chunk_rowcol):
            _assert_flips_bounded(mine, oracle(
                blocks[s], qp[s].expand(T, N), clip, want_q=True))
        explicit = tk.mbcodec_chunk_cuda(
            blocks[s].contiguous(), qp[s].expand(T, N).contiguous(), clip,
            want_q=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(mine, explicit))


def test_chunk_kernels_are_bitwise_repeatable(cuda):
    """No atomics: two calls of each entry point give the same bits."""
    blocks, qp = _ragged_blocks(cuda, 3, 10, 7)
    pooled = torch.rand(3, RAGGED_MB, device=cuda)
    knobs = torch.tensor([0.5, 28.0, 42.0], device=cuda)
    for clip in (False, True):
        calls = [(tk.mbcodec_chunk_cuda(blocks[0], qp[0], clip,
                                        want_q=True),
                  tk.mbcodec_chunk_scores_cuda(blocks, pooled, knobs,
                                               RAGGED_C, clip, want_q=True),
                  tk.mbcodec_frame_cuda(blocks[0, 3], qp[0, 3],
                                        want_q=True))
                 for _ in range(2)]
        torch.cuda.synchronize()
        for first, second in zip(*calls):
            assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_chunk_kernels_replay_in_a_cuda_graph(cuda):
    """The three entry points captured in one CUDA graph (D and w travel
    in the launch's parameters) replay bit for bit as eager calls, with
    new inputs copied into the captured tensors before each replay."""
    frames = torch.from_numpy(_frames(T=10, H=96, W=160)).to(cuda)
    blocks, n_mb, C = tops._chunk_blocks(frames)
    qp = torch.full(blocks.shape[:2], 30.0, device=cuda)
    fleet = torch.stack([blocks, blocks.flip(0)])
    pooled = torch.rand(2, n_mb, device=cuda)
    knobs = torch.tensor([0.5, 28.0, 42.0], device=cuda)

    def calls():
        return (tk.mbcodec_chunk_cuda(blocks, qp, True),
                tk.mbcodec_chunk_scores_cuda(fleet, pooled, knobs, C, False),
                tk.mbcodec_frame_cuda(blocks[4], qp[4]))

    calls()  # loads the library off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    for seed in (1, 2):
        rng = np.random.RandomState(seed)
        fresh = torch.from_numpy(rng.rand(*blocks.shape).astype(np.float32))
        blocks.copy_(fresh)
        fleet.copy_(torch.stack([fresh, fresh.flip(0)]))
        qp.uniform_(20, 45)
        pooled.uniform_()
        graph.replay()
        want = calls()
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_chunk_wrappers_refuse_blocks_off_a_16_byte_boundary(cuda):
    """The kernel reads rows as 16-byte vectors: a contiguous view 4 bytes
    into its storage is refused by every entry point, not a fault."""
    blocks, qp = _ragged_blocks(cuda, 1, 2, 0)
    shifted = torch.zeros(blocks.numel() + 1, device=cuda)[1:]
    shifted = shifted.view(blocks.shape)
    with pytest.raises(ValueError, match="16-byte"):
        tk.mbcodec_chunk_cuda(shifted[0], qp[0])
    with pytest.raises(ValueError, match="16-byte"):
        tk.mbcodec_frame_cuda(shifted[0, 0], qp[0, 0])
    with pytest.raises(ValueError, match="16-byte"):
        tk.mbcodec_chunk_scores_cuda(shifted,
                                     torch.rand(1, RAGGED_MB, device=cuda),
                                     torch.tensor([0.5, 30.0, 40.0],
                                                  device=cuda), RAGGED_C)
    tk.mbcodec_chunk_cuda(blocks[0], qp[0])  # the context is still usable
    torch.cuda.synchronize()


def test_chunk_kernels_refuse_a_dct_matrix_other_than_the_compiled_one(
        cuda, monkeypatch):
    """D is compiled into the kernel; a launch of any entry point handed
    another D raises instead of coding with the wrong transform."""
    blocks, qp = _ragged_blocks(cuda, 1, 2, 0)
    other = tk.dct_matrix().copy()
    other[3, 5] = np.nextafter(other[3, 5], np.float32(1))
    w = tk.freq_weight()
    monkeypatch.setattr(tk, "_host_consts",
                        lambda: (other.ctypes.data, w.ctypes.data))
    with pytest.raises(RuntimeError, match="dct_matrix"):
        tk.mbcodec_chunk_cuda(blocks[0], qp[0])
    with pytest.raises(RuntimeError, match="dct_matrix"):
        tk.mbcodec_frame_cuda(blocks[0, 0], qp[0, 0])
    with pytest.raises(RuntimeError, match="dct_matrix"):
        tk.mbcodec_chunk_scores_cuda(blocks,
                                     torch.rand(1, RAGGED_MB, device=cuda),
                                     torch.tensor([0.5, 30.0, 40.0],
                                                  device=cuda), RAGGED_C)


def test_fleet_engine_overlaps_on_the_card(cuda):
    """The fused fleet engine on the card: one scores launch per chunk
    (plus warm-up), host copies in pinned memory, and results equal to the
    serialized loop."""
    from repro_torch.core.accmodel import AccModel
    from repro_torch.engine import EngineConfig, MultiStreamEngine
    from repro_torch.engine.multistream import _to_host
    from repro_torch.vision.dnn import FinalDNN

    g = torch.Generator().manual_seed(0)
    dnn = FinalDNN("detection", 8, generator=g, device="cuda")
    am = AccModel(8, generator=g, device="cuda")
    frames = np.stack([_frames(T=20, seed=s) for s in range(3)])
    assert _to_host({"x": torch.ones(4, device=cuda)})["x"].is_pinned()
    runs = {}
    for overlap in (True, False):
        name = tk.scores_kernel_name(False)
        before = tk.LAUNCHES[name]
        runs[overlap] = MultiStreamEngine(dnn, am, config=EngineConfig(
            impl="fused", overlap=overlap)).run(frames)
        assert tk.LAUNCHES[name] - before == 2 + (2 if overlap else 1)
    for a, b in zip(runs[True].streams, runs[False].streams):
        assert [c.accuracy for c in a.chunks] == [c.accuracy
                                                  for c in b.chunks]
        assert [c.bytes for c in a.chunks] == [c.bytes for c in b.chunks]


@pytest.fixture
def exact_convs(cuda):
    """cuDNN without TF32 for the duration of a test."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = before


def _accgrad_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("shape", [(4, 384, 640, 3), (2, 32, 32, 1),
                                   (3, 64, 16, 3), (1, 16, 160, 3),
                                   (2, 48, 80, 5)])
def test_accgrad_reduce_matches_plain_version(cuda, shape):
    from repro_torch.kernels.accgrad_reduce import kernel as ak
    from repro_torch.kernels.accgrad_reduce.ops import accgrad_reduce
    from repro_torch.kernels.accgrad_reduce.ref import accgrad_reduce_ref

    g, hq, lq = (t.to(cuda) for t in _accgrad_inputs(shape, shape[1]))
    before = ak.LAUNCHES["accgrad_reduce"]
    got = accgrad_reduce(g, hq, lq)
    assert ak.LAUNCHES["accgrad_reduce"] == before + 1  # one per batch
    want = accgrad_reduce_ref(g, hq, lq)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], shape[1] // 16, shape[2] // 16)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
    for b in range(shape[0]):
        one = accgrad_reduce(g[b], hq[b], lq[b])  # (H, W, C): one frame
        assert torch.equal(one, got[b])


def test_accgrad_reduce_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.accgrad_reduce.kernel import accgrad_reduce_cuda

    g, hq, lq = (t.to(cuda) for t in _accgrad_inputs((2, 32, 48, 3), 1))
    with pytest.raises(ValueError, match="float32"):
        accgrad_reduce_cuda(g.double(), hq, lq)
    with pytest.raises(ValueError, match="shape"):
        accgrad_reduce_cuda(g, hq[:, :16].contiguous(), lq)
    with pytest.raises(ValueError, match="contiguous"):
        accgrad_reduce_cuda(g, hq.transpose(1, 2).contiguous().transpose(
            1, 2), lq)
    with pytest.raises(ValueError, match="CUDA tensor"):
        accgrad_reduce_cuda(g, hq, lq.cpu())
    with pytest.raises(ValueError, match="macroblocks"):
        accgrad_reduce_cuda(*(t[:, :24].contiguous() for t in (g, hq, lq)))
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        accgrad_reduce_cuda(g[0], hq[0], lq[0])


def test_accgrad_frames_on_the_card_matches_the_cpu(exact_convs):
    """One kernel launch per batch on the card, the same AccGrad grids as
    the plain path on the CPU, and no parameter gathers a gradient."""
    from repro_torch.core.accgrad import accgrad_frames
    from repro_torch.kernels.accgrad_reduce import kernel as ak
    from repro_torch.vision.dnn import FinalDNN

    g = torch.Generator().manual_seed(4)
    cpu_net = FinalDNN("detection", 8, generator=g, device="cpu")
    with torch.no_grad():  # spread the heads' logits (see the CPU tests)
        for head in ("heat", "wh", "off"):
            getattr(cpu_net, head).c2.weight.mul_(100.0)
    card_net = FinalDNN("detection", 8, device="cuda")
    card_net.load_state_dict(cpu_net.state_dict())
    frames = _frames(T=4, H=96, W=160, seed=6)
    hq = torch.from_numpy(frames)
    lq = (hq + 0.05 * torch.from_numpy(_frames(T=4, H=96, W=160, seed=7))
          ).clamp(0, 1)
    want = accgrad_frames(cpu_net, hq, lq)
    before = ak.LAUNCHES["accgrad_reduce"]
    got = accgrad_frames(card_net, hq.to(exact_convs), lq.to(exact_convs))
    torch.cuda.synchronize()
    assert ak.LAUNCHES["accgrad_reduce"] == before + 1
    assert got.shape == (4, 6, 10) and got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    assert all(p.grad is None for p in card_net.parameters())


def _attn_inputs(cuda, B, S, KV, G, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).to(cuda, dtype)
            for shape in ((B, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd))]


# decode_attn against its plain version: fp32 sums in another order over
# O(1) values, atol 1e-5 and rtol 1e-4 (the reference's kernel bound);
# for bf16 caches the same, since both read the same bf16 values.
@pytest.mark.parametrize("dims", [
    (2, 2048, 5, 3, 64, 1087),  # the smollm path's shape, G=3
    (3, 1000, 2, 3, 64, 0),     # S no block divides, only position 0
    (1, 777, 1, 8, 32, 300),    # pos inside a tile, G=8, hd 32
    (2, 300, 4, 1, 64, 299),    # G=1, the whole cache
    (16, 4500, 5, 3, 64, 4321),  # several splits of a long cache
    (2, 32768, 5, 3, 64, 0)])   # every split but the first one empty
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_matches_plain_version(cuda, dims, dtype):
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    B, S, KV, G, hd, pos = dims
    q, k, v = _attn_inputs(cuda, B, S, KV, G, hd, dtype, seed=S)
    before = dk.LAUNCHES["decode_attn"]
    got = decode_attn(q, k, v, pos)
    assert dk.LAUNCHES["decode_attn"] == before + 1
    want = decode_attn_ref(q, k, v, pos)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, hd)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_takes_every_group_size(cuda, G, hd, dtype):
    """Each (G, hd) instantiation, at a pos inside a tile and a split."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _attn_inputs(cuda, 3, 1500, 2, G, hd, dtype, seed=10 * G + hd)
    got = decode_attn_cuda(q, k, v, 1234)
    want = decode_attn_ref(q, k, v, 1234)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


def test_decode_attn_is_bitwise_repeatable(cuda):
    """The last block of each (b, kv) merges its splits in split order, so
    two calls agree bit for bit whatever order the blocks finish in."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda

    q, k, v = _attn_inputs(cuda, 16, 8192, 5, 3, 64, torch.bfloat16, seed=4)
    first = decode_attn_cuda(q, k, v, 8000)
    for _ in range(3):
        assert torch.equal(decode_attn_cuda(q, k, v, 8000), first)


def test_decode_attn_graph_replays_at_device_positions(cuda):
    """One call captured with pos in a device tensor serves every pos: each
    replay equals an eager call with the int, bit for bit, and the plain
    version within the bound."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _attn_inputs(cuda, 4, 2048, 5, 3, 64, torch.bfloat16, seed=5)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    dk.decode_attn_cuda(q, k, v, pos)  # loads the library off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attn_cuda(q, k, v, pos)
    for p in (1087, 0, 2047):
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, dk.decode_attn_cuda(q, k, v, p))
        np.testing.assert_allclose(
            out.cpu().numpy(), decode_attn_ref(q, k, v, p).cpu().numpy(),
            atol=1e-5, rtol=1e-4)


def test_decode_attn_device_pos_out_of_range_gives_nan(cuda):
    """A device pos outside 0..S-1 cannot be raised without a synchronise:
    the output is NaN throughout, and the next call is right."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _attn_inputs(cuda, 2, 300, 5, 3, 64, torch.bfloat16, seed=6)
    for bad in (300, -1):
        pos = torch.tensor([bad], dtype=torch.int32, device=cuda)
        assert bool(decode_attn_cuda(q, k, v, pos).isnan().all())
    pos = torch.tensor([299], dtype=torch.int32, device=cuda)
    np.testing.assert_allclose(
        decode_attn_cuda(q, k, v, pos).cpu().numpy(),
        decode_attn_ref(q, k, v, 299).cpu().numpy(), atol=1e-5, rtol=1e-4)


def test_decode_attn_ignores_what_lies_past_pos(cuda):
    """Garbage (inf, NaN) after pos changes nothing: masked positions are
    never read."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda, torch.bfloat16)
               for shape in ((2, 5, 3, 64), (2, 1500, 5, 64),
                             (2, 1500, 5, 64)))
    clean = decode_attn_cuda(q, k, v, 700)
    k[:, 701:], v[:, 701:] = float("inf"), float("nan")
    assert torch.equal(decode_attn_cuda(q, k, v, 700), clean)


def test_decode_attn_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda

    q = torch.zeros((2, 5, 3, 64), device=cuda)
    k = torch.zeros((2, 100, 5, 64), device=cuda)
    with pytest.raises(ValueError, match="pos"):
        decode_attn_cuda(q, k, k, 100)
    with pytest.raises(ValueError, match="bfloat16"):
        decode_attn_cuda(q, k.bfloat16(), k, 5)
    with pytest.raises(ValueError, match="match"):
        decode_attn_cuda(q, k[:, :, :4].contiguous(), k, 5)
    with pytest.raises(ValueError, match="group"):
        decode_attn_cuda(torch.zeros((2, 1, 9, 64), device=cuda),
                         k[:, :, :1].contiguous(), k[:, :, :1].contiguous(),
                         5)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attn_cuda(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         k, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attn_cuda(q, k.cpu(), k, 5)
    # a contiguous view 4 bytes into its storage: raised, not a fault
    shifted = torch.zeros(k.numel() + 1, device=cuda)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attn_cuda(q, shifted, k, 5)
    for pos, what in ((torch.tensor([5], device=cuda), "int32"),
                      (torch.tensor([5], dtype=torch.int32), "device"),
                      (torch.tensor([5, 6], dtype=torch.int32, device=cuda),
                       "one element")):
        with pytest.raises(ValueError, match=what):
            decode_attn_cuda(q, k, k, pos)
    decode_attn_cuda(q, k, k, 5)  # the context is still usable


def _wkv_inputs(B, S, H, hd, seed, ld_low=None, s0_scale=0.2):
    """Seeded r, k, v (x0.5), log-decays (-exp(N(-1, 0.5)) as the
    reference's tests, or uniform in [ld_low, -1e-4]), u and s0."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    if ld_low is None:
        ld = -np.exp(0.5 * rng.standard_normal((B, S, H, hd)) - 1.0)
    else:
        ld = rng.uniform(ld_low, -1e-4, (B, S, H, hd))
    u = 0.3 * rng.standard_normal((H, hd))
    s0 = s0_scale * rng.standard_normal((B, H, hd, hd))
    return [torch.from_numpy(x.astype(np.float32))
            for x in (r, k, v, ld, u, s0)]


# wkv6 against the sequential oracle: atol 2e-4, rtol 1e-3, the
# reference's kernel bound (tests/test_kernels.py); every output finite.
# Lengths cross every boundary of the kernel's plan (ref.segment_plan):
# chunks of 16, sub-blocks of 8, segments of up to 128 tokens, clusters of
# up to 8 segments, and rounds past 1024 tokens.
@pytest.mark.parametrize("dims", [
    (16, 1, 32, 64, None),     # a decode step: one token, no padding
    (2, 1000, 3, 64, -8.0),    # ragged last chunk, fast decays
    (1, 77, 2, 32, None),      # hd 32, ragged
    (3, 64, 4, 64, -3.0),      # where the reference kernel gives NaN
    (2, 2, 3, 64, None),       # one segment, one short chunk
    (2, 16, 2, 64, None),      # one whole chunk
    (2, 17, 2, 32, -8.0),      # two segments, the second of one token
    (1, 127, 2, 64, None),     # 8 segments of 16, the last short
    (1, 128, 2, 64, -3.0),     # 8 whole segments of 16
    (1, 129, 2, 64, None),     # 5 segments of 32, the last of one token
    (1, 1024, 2, 64, None),    # 8 segments of 128: the prefill's plan
    (1, 1025, 2, 32, -8.0),    # a second round of one token
    (1, 4096, 1, 64, None)])   # four full rounds
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_matches_sequential_oracle(cuda, dims, dtype):
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    B, S, H, hd, ld_low = dims
    r, k, v, ld, u, s0 = (t.to(cuda) for t in _wkv_inputs(B, S, H, hd, S,
                                                          ld_low))
    r, k, v = (t.to(dtype) for t in (r, k, v))
    before = wk.LAUNCHES["wkv6"]
    o, s = wkv6(r, k, v, ld, u, s0)
    assert wk.LAUNCHES["wkv6"] == before + 1
    o_ref, s_ref = wkv6_ref(r, k, v, ld, u, s0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(o.cpu().numpy(), o_ref.cpu().numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(s.cpu().numpy(), s_ref.cpu().numpy(),
                               atol=2e-4, rtol=1e-3)


def test_wkv6_chained_steps_equal_one_call(cuda):
    """Prefill then token-by-token steps carry the state as one call
    over the whole sequence does (the serving path's use)."""
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda

    r, k, v, ld, u, s0 = (t.to(cuda) for t in _wkv_inputs(2, 40, 2, 64, 3))
    o_all, s_all = wkv6_cuda(r, k, v, ld, u, s0)
    o_pre, s = wkv6_cuda(*(t[:, :37].contiguous() for t in (r, k, v, ld)),
                         u, s0)
    outs = [o_pre]
    for t in range(37, 40):
        o_t, s = wkv6_cuda(*(x[:, t:t + 1].contiguous()
                             for x in (r, k, v, ld)), u, s)
        outs.append(o_t)
    torch.cuda.synchronize()
    np.testing.assert_allclose(torch.cat(outs, 1).cpu().numpy(),
                               o_all.cpu().numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(s.cpu().numpy(), s_all.cpu().numpy(),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("S", [1, 1024])
def test_wkv6_is_bitwise_repeatable(cuda, S):
    """No atomics and a fixed order of the segments' fold: two calls on
    the same inputs give the same bits."""
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda

    r, k, v, ld, u, s0 = (t.to(cuda) for t in _wkv_inputs(4, S, 8, 64, 5))
    r, k, v = (t.bfloat16() for t in (r, k, v))
    first = wkv6_cuda(r, k, v, ld, u, s0)
    second = wkv6_cuda(r, k, v, ld, u, s0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("S", [1, 1024])
def test_wkv6_graph_replays_as_eager_calls(cuda, S):
    """A CUDA graph that captured ``wkv6_cuda`` replays bit for bit the
    eager call, at the prefill (S=1024) and decode (S=1) shapes, with new
    inputs copied into the captured tensors before each replay."""
    from repro_torch.kernels.wkv6 import kernel as wk

    xs = [t.to(cuda) for t in _wkv_inputs(16, S, 32, 64, 11)]
    xs[:3] = [t.bfloat16() for t in xs[:3]]
    wk.wkv6_cuda(*xs)  # builds the library and sets the kernel's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wk.wkv6_cuda(*xs)
    for seed in (12, 13):
        fresh = [t.to(cuda) for t in _wkv_inputs(16, S, 32, 64, seed)]
        for dst, src in zip(xs, fresh):
            dst.copy_(src)
        graph.replay()
        want = wk.wkv6_cuda(*xs)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_wkv6_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda

    r, k, v, ld, u, s0 = (t.to(cuda) for t in _wkv_inputs(1, 8, 2, 64, 0))
    with pytest.raises(ValueError, match="float32"):
        wkv6_cuda(r, k, v, ld.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="but v"):
        wkv6_cuda(r, k, v.bfloat16(), ld, u, s0)
    with pytest.raises(ValueError, match="shape"):
        wkv6_cuda(r, k, v, ld, u, s0[:, :1].contiguous())
    with pytest.raises(ValueError, match="head size"):
        wkv6_cuda(*(t[..., :16].contiguous() for t in (r, k, v, ld, u)),
                  s0[..., :16, :16].contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6_cuda(r, k, v, ld, u.cpu(), s0)
