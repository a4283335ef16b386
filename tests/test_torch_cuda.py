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
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_takes_every_group_size(cuda, G, hd, dtype):
    """Each (G, hd) instantiation, at a pos inside a tile and a split, one
    launch. Its body: bf16 at hd 64 and 128, G 1 (``bf16_g1_body``) and G
    5..8 (``bf16_mma_body``), walk_bf16_mma; every other (G 2..4, hd 32,
    fp32) the CUDA-core body."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    tensor_cores = dtype == torch.bfloat16 and hd in (64, 128)
    assert dk.bf16_mma_body(dtype, False, hd, G) is (tensor_cores and G >= 5)
    assert dk.bf16_g1_body(dtype, False, hd, G) is (tensor_cores and G == 1)
    q, k, v = _attn_inputs(cuda, 3, 1500, 2, G, hd, dtype, seed=10 * G + hd)
    before = dk.LAUNCHES["decode_attn"]
    got = decode_attn_cuda(q, k, v, 1234)
    assert dk.LAUNCHES["decode_attn"] == before + 1
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


def _int8_attn_inputs(cuda, B, S, KV, G, hd, dtype, seed):
    """q of ``dtype``; k and v in the int8 cache form of the model's
    ``quantize_kv``."""
    from repro_torch.models.layers import quantize_kv

    q, k, v = _attn_inputs(cuda, B, S, KV, G, hd, torch.float32, seed)
    return q.to(dtype), quantize_kv(k), quantize_kv(v)


# head dim 80 (stablelm-3b) with a bf16, an fp32 and an int8 cache (q bf16
# or fp32): the plain version reads the int8 form as cache_read(c,
# q.dtype), the kernel dequantizes the same values, so the same bound
@pytest.mark.parametrize("dims", [
    (2, 2048, 32, 1, 80, 1087),  # stablelm's decode shape, batch cut to 2
    (3, 1000, 2, 3, 80, 0),      # only position 0
    (1, 777, 1, 8, 80, 300),     # pos inside a tile, G=8
    (2, 4500, 4, 2, 80, 4321)])  # several splits
@pytest.mark.parametrize("cache", ["bf16", "fp32", "int8,bf16", "int8,fp32"])
def test_decode_attn_at_head_dim_80_matches_plain_version(cuda, dims, cache):
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    B, S, KV, G, hd, pos = dims
    dtype = torch.bfloat16 if cache.endswith("bf16") else torch.float32
    make = _int8_attn_inputs if cache.startswith("int8") else _attn_inputs
    q, k, v = make(cuda, B, S, KV, G, hd, dtype, seed=S + G)
    before = dk.LAUNCHES["decode_attn"]
    got = decode_attn(q, k, v, pos)
    assert dk.LAUNCHES["decode_attn"] == before + 1
    want = decode_attn_ref(q, k, v, pos)
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, hd)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_int8_cache_takes_every_group_and_head_dim(cuda, G, hd,
                                                               dtype):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _int8_attn_inputs(cuda, 3, 1500, 2, G, hd, dtype,
                                seed=10 * G + hd)
    np.testing.assert_allclose(
        decode_attn_cuda(q, k, v, 1234).cpu().numpy(),
        decode_attn_ref(q, k, v, 1234).cpu().numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("G", [1, 5])
def test_decode_attn_bf16_head_dim_80_takes_group_sizes(cuda, G):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _attn_inputs(cuda, 3, 1500, 2, G, 80, torch.bfloat16, seed=G)
    np.testing.assert_allclose(
        decode_attn_cuda(q, k, v, 1234).cpu().numpy(),
        decode_attn_ref(q, k, v, 1234).cpu().numpy(), atol=1e-5, rtol=1e-4)


def test_decode_attn_int8_graph_replays_and_ignores_what_lies_past_pos(cuda):
    """hd 80, int8: a captured call replayed at device positions equals
    eager calls bit for bit; values and scales past pos change nothing;
    a device pos past the cache gives NaN."""
    from repro_torch.kernels.decode_attn import kernel as dk

    q, k, v = _int8_attn_inputs(cuda, 4, 2048, 32, 1, 80, torch.bfloat16,
                                seed=8)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    dk.decode_attn_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attn_cuda(q, k, v, pos)
    for p in (1087, 0, 2047):
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, dk.decode_attn_cuda(q, k, v, p))
    clean = dk.decode_attn_cuda(q, k, v, 700)
    for c in (k, v):
        c["q"][:, 701:] = 127
        c["s"][:, 701:] = float("nan")
    assert torch.equal(dk.decode_attn_cuda(q, k, v, 700), clean)
    pos.fill_(2048)
    graph.replay()
    assert bool(out.isnan().all())


def test_decode_attn_wrapper_rejects_a_malformed_int8_cache(cuda):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda

    q, k, v = _int8_attn_inputs(cuda, 2, 100, 2, 1, 80, torch.bfloat16,
                                seed=9)
    with pytest.raises(ValueError, match="both"):
        decode_attn_cuda(q, k, v["q"].float(), 5)
    with pytest.raises(ValueError, match="'q' and 's'"):
        decode_attn_cuda(q, {"q": k["q"]}, v, 5)
    with pytest.raises(ValueError, match="int8"):
        decode_attn_cuda(q, {"q": k["q"].float(), "s": k["s"]}, v, 5)
    with pytest.raises(ValueError, match="scales"):
        decode_attn_cuda(q, {"q": k["q"], "s": k["s"][:, :50].contiguous()},
                         v, 5)
    with pytest.raises(ValueError, match="head dim"):
        decode_attn_cuda(q[..., :48].contiguous(),
                         {n: t[..., :48].contiguous() if n == "q" else t
                          for n, t in k.items()},
                         {n: t[..., :48].contiguous() if n == "q" else t
                          for n, t in v.items()}, 5)
    decode_attn_cuda(q, k, v, 5)  # the context is still usable


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attn_int8_at_stablelm_decode_shape(cuda, dtype):
    """stablelm-3b's whole decode shape (B 16, S 2048, KV 32, G 1, hd 80,
    pos 1087) on its int8 cache, against the plain version."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _int8_attn_inputs(cuda, 16, 2048, 32, 1, 80, dtype, seed=11)
    got = decode_attn_cuda(q, k, v, 1087)
    want = decode_attn_ref(q, k, v, 1087)
    assert got.shape == (16, 32, 1, 80)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


def _tie_scales(n, seed):
    """fp32 scales in 1e-8/127 .. 1e6/127 whose low 16 bits are 0x8000:
    times +-1, +-2 or +-64 each product is a tie of the bf16 rounding."""
    rng = np.random.default_rng(seed)
    top = rng.integers(0x2EAD, 0x45F6, n, dtype=np.uint32)
    return ((top << np.uint32(16)) | np.uint32(0x8000)).view(np.float32)


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attn_int8_reads_v_bit_for_bit(cuda, hd, dtype):
    """At pos 0 the output of every query head is the dequantized V row
    itself (one weight of exactly 1): all 255 int8 values spread over the
    channels of 16 rows, against scales whose bf16 rounding ties, equal
    ``cache_read(v, q's type)`` bit for bit. Values and scales past pos are
    garbage (NaN scales), never read."""
    _reads_v_bit_for_bit(cuda, hd, dtype, G=3)


@pytest.mark.parametrize("hd", [64, 128])
def test_decode_attn_int8_reads_v_bit_for_bit_at_group_8(cuda, hd):
    """The same at G 8 with a bf16 q, where the tensor-core body's p.v
    takes V as its B operand, a lane's channels spread over 16 (8)
    n-tiles and permuted back at the write."""
    _reads_v_bit_for_bit(cuda, hd, torch.bfloat16, G=8)


def _reads_v_bit_for_bit(cuda, hd, dtype, G):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.models.layers import cache_read

    B, S, KV = 4, 300, 4
    rng = np.random.default_rng(hd)
    values = rng.permutation(np.resize(np.arange(-127, 128), B * KV * hd))
    q, k, v = _int8_attn_inputs(cuda, B, S, KV, G, hd, dtype, seed=hd)
    v["q"][:, 0] = torch.from_numpy(values.reshape(B, KV, hd).astype(
        np.int8)).to(cuda)
    v["s"][:, 0, :, 0] = torch.from_numpy(_tie_scales(B * KV, hd).reshape(
        B, KV)).to(cuda)
    for c in (k, v):
        c["s"][:, 1:] = float("nan")
    got = decode_attn_cuda(q, k, v, 0)
    want = cache_read({n: t[:, :1] for n, t in v.items()}, dtype).float()
    want = want[:, 0, :, None, :].expand(B, KV, G, hd)
    assert torch.equal(got.view(torch.int32), want.contiguous().view(
        torch.int32))


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_int8_is_bitwise_repeatable(cuda, G, hd, dtype):
    """Every int8 instantiation, over 23 splits merged in order: a second
    call equals the first bit for bit."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda

    q, k, v = _int8_attn_inputs(cuda, 4, 3000, 2, G, hd, dtype,
                                seed=100 + 10 * G + hd)
    first = decode_attn_cuda(q, k, v, 2900)
    assert bool(torch.isfinite(first).all())
    assert torch.equal(decode_attn_cuda(q, k, v, 2900), first)


# head dim 128 (olmoe-1b-7b's KV 16, G 1 on a bf16 cache; moonshot's int8
# cache; qwen's KV 8, G 8): the same bound against the plain version
@pytest.mark.parametrize("dims", [
    (2, 2048, 16, 1, 128, 1087),  # olmoe's decode shape, batch cut to 2
    (2, 2048, 8, 8, 128, 1087),   # qwen's G=8
    (3, 1000, 2, 3, 128, 0),      # only position 0
    (1, 777, 1, 5, 128, 300),     # pos inside a tile
    (2, 4500, 4, 2, 128, 4321)])  # several splits
@pytest.mark.parametrize("cache", ["bf16", "fp32", "int8,bf16", "int8,fp32"])
def test_decode_attn_at_head_dim_128_matches_plain_version(cuda, dims,
                                                           cache):
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    B, S, KV, G, hd, pos = dims
    dtype = torch.bfloat16 if cache.endswith("bf16") else torch.float32
    make = _int8_attn_inputs if cache.startswith("int8") else _attn_inputs
    q, k, v = make(cuda, B, S, KV, G, hd, dtype, seed=S + G + 1)
    before = dk.LAUNCHES["decode_attn"]
    got = decode_attn(q, k, v, pos)
    assert dk.LAUNCHES["decode_attn"] == before + 1
    want = decode_attn_ref(q, k, v, pos)
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, hd)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("cache", ["bf16", "fp32", "int8,bf16", "int8,fp32"])
def test_decode_attn_head_dim_128_takes_every_group_and_cache(cuda, G,
                                                              cache):
    """Each of the 32 hd-128 instantiations, over 12 splits merged in
    order: within the bound of the plain version, finite, and a second call
    equal to the first bit for bit."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    dtype = torch.bfloat16 if cache.endswith("bf16") else torch.float32
    make = _int8_attn_inputs if cache.startswith("int8") else _attn_inputs
    q, k, v = make(cuda, 3, 3000, 2, G, 128, dtype, seed=200 + G)
    first = decode_attn_cuda(q, k, v, 2900)
    assert bool(torch.isfinite(first).all())
    np.testing.assert_allclose(
        first.cpu().numpy(), decode_attn_ref(q, k, v, 2900).cpu().numpy(),
        atol=1e-5, rtol=1e-4)
    assert torch.equal(decode_attn_cuda(q, k, v, 2900), first)


# G 8 at hd 128 (llama-3.2-vision-90b's 64 heads over 8) over caches whose
# length no tile divides (64 positions of the bf16 and fp32 bodies, 128
# of the int8 one): 1,601 patches of one image tile, and the cross layers'
# 6,404 image tokens, read whole (pos S - 1, the cross decode) and up to a
# smaller pos past which garbage lies; the same bound as above
@pytest.mark.parametrize("dims", [
    (2, 1601, 8, 8, 128, 1600),
    (2, 1601, 8, 8, 128, 1000),
    (2, 6404, 8, 8, 128, 6403),
    (2, 6404, 8, 8, 128, 5000),
    (16, 6404, 8, 8, 128, 6403)])  # the cross layers' decode shape
@pytest.mark.parametrize("cache", ["bf16", "fp32", "int8,bf16", "int8,fp32"])
def test_decode_attn_group_8_on_caches_no_tile_divides(cuda, dims, cache):
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    B, S, KV, G, hd, pos = dims
    dtype = torch.bfloat16 if cache.endswith("bf16") else torch.float32
    int8 = cache.startswith("int8")
    make = _int8_attn_inputs if int8 else _attn_inputs
    q, k, v = make(cuda, B, S, KV, G, hd, dtype, seed=S + pos)
    before = dk.LAUNCHES["decode_attn"]
    got = decode_attn(q, k, v, pos)
    assert dk.LAUNCHES["decode_attn"] == before + 1
    want = decode_attn_ref(q, k, v, pos)
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, hd)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)
    if pos < S - 1:  # garbage past pos changes nothing
        if int8:
            k["q"][:, pos + 1:], v["q"][:, pos + 1:] = 127, -127
            k["s"][:, pos + 1:], v["s"][:, pos + 1:] = (float("inf"),
                                                        float("nan"))
        else:
            k[:, pos + 1:], v[:, pos + 1:] = float("inf"), float("nan")
        assert torch.equal(decode_attn(q, k, v, pos), got)


@pytest.mark.parametrize("cache", ["bf16", "int8,bf16"])
def test_decode_attn_head_dim_128_graph_replays_at_device_positions(cuda,
                                                                   cache):
    """olmoe's layer (KV 16, G 1) and moonshot's int8 one at hd 128: a
    captured call replayed at device positions equals eager calls bit for
    bit and the plain version within the bound; what lies past pos is
    never read; a device pos past the cache gives NaN."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    make = _int8_attn_inputs if cache.startswith("int8") else _attn_inputs
    q, k, v = make(cuda, 4, 2048, 16, 1, 128, torch.bfloat16, seed=12)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    dk.decode_attn_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attn_cuda(q, k, v, pos)
    for p in (1087, 0, 255, 256, 2047):
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, dk.decode_attn_cuda(q, k, v, p))
        np.testing.assert_allclose(
            out.cpu().numpy(), decode_attn_ref(q, k, v, p).cpu().numpy(),
            atol=1e-5, rtol=1e-4)
    clean = dk.decode_attn_cuda(q, k, v, 700)
    if isinstance(k, dict):
        for c in (k, v):
            c["q"][:, 701:] = 127
            c["s"][:, 701:] = float("nan")
    else:
        k[:, 701:], v[:, 701:] = float("inf"), float("nan")
    assert torch.equal(dk.decode_attn_cuda(q, k, v, 700), clean)
    pos.fill_(2048)
    graph.replay()
    assert bool(out.isnan().all())


# the int8 body on the tensor cores (walk_int8_mma; bf16 q at hd 64 and
# 128): moonshot-v1-16b-a3b's hd 128, G 1, G 2 (two query heads a KV
# head), smollm's hd 64, G 3, and past G 4, where p.v runs as O += P V,
# llama-3.2-vision-90b's and qwen1.5-110b's hd 128, G 8, G 5, hd 64 at G
# 8, and yi-34b's hd 128, G 7 (56 heads over 8)
@pytest.mark.parametrize("hd,G", [(128, 1), (128, 2), (64, 3), (128, 8),
                                  (128, 5), (64, 8), (128, 7)])
def test_decode_attn_tensor_core_int8_body(cuda, hd, G):
    """Over many splits (2 row groups of 4 KV heads, or past G 4 one KV
    head a block and one row: ~130 splits of 4500 positions) against the
    plain version at positions on and off the splits' and tiles' edges,
    bit for bit a second call; one captured call replayed at device
    positions equals eager calls bit for bit; values and scales past pos
    (127 and NaN) change nothing."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    assert dk.mma_body(torch.bfloat16, True, hd, G)
    B, KV = (2, 4) if G <= 4 else (1, 1)
    q, k, v = _int8_attn_inputs(cuda, B, 4500, KV, G, hd, torch.bfloat16,
                                seed=300 + hd + G)
    kvg, split_len, nsplit = dk.launch_plan(q.device, torch.bfloat16, True,
                                            B, KV, G, hd, 4500)
    assert kvg == (4 if G <= 4 else 1) and nsplit > 100
    for p in (0, 31, 32, 1087, 2222, 4499):
        got = dk.decode_attn_cuda(q, k, v, p)
        np.testing.assert_allclose(
            got.cpu().numpy(), decode_attn_ref(q, k, v, p).cpu().numpy(),
            atol=1e-5, rtol=1e-4)
        assert torch.equal(dk.decode_attn_cuda(q, k, v, p), got)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    dk.decode_attn_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attn_cuda(q, k, v, pos)
    for p in (1087, 0, 255, 4499):
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, dk.decode_attn_cuda(q, k, v, p))
    clean = dk.decode_attn_cuda(q, k, v, 700)
    for c in (k, v):
        c["q"][:, 701:] = 127
        c["s"][:, 701:] = float("nan")
    assert torch.equal(dk.decode_attn_cuda(q, k, v, 700), clean)


# the bf16 cache's body on the tensor cores (walk_bf16_mma; bf16 q and
# cache at hd 64 and 128, G 5..8): jamba-1.5-large-398b's hd 128, G 8, and
# the other instantiations, over many splits of one row
@pytest.mark.parametrize("hd,G", [(128, 8), (128, 5), (128, 6), (128, 7),
                                  (64, 8), (64, 5)])
def test_decode_attn_tensor_core_bf16_body(cuda, hd, G):
    """One KV head of one b (one row: a split for each slot of the wave,
    ~130 or more splits of 4500 positions merged in order) against the
    plain version at positions on and off the splits' and tiles' edges,
    one launch a call, bit for bit a second call; what lies past pos (inf
    and NaN) changes nothing."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    bf16 = torch.bfloat16
    assert dk.bf16_mma_body(bf16, False, hd, G)
    q, k, v = _attn_inputs(cuda, 1, 4500, 1, G, hd, bf16, seed=400 + hd + G)
    kvg, split_len, nsplit = dk.launch_plan(cuda, bf16, False, 1, 1, G, hd,
                                            4500)
    assert kvg == 1 and nsplit > 100
    for p in (0, 15, 16, 127, 1087, 2222, 4499):
        before = dk.LAUNCHES["decode_attn"]
        got = dk.decode_attn_cuda(q, k, v, p)
        assert dk.LAUNCHES["decode_attn"] == before + 1
        np.testing.assert_allclose(
            got.cpu().numpy(), decode_attn_ref(q, k, v, p).cpu().numpy(),
            atol=1e-5, rtol=1e-4)
        assert torch.equal(dk.decode_attn_cuda(q, k, v, p), got)
    clean = dk.decode_attn_cuda(q, k, v, 700)
    k[:, 701:], v[:, 701:] = float("inf"), float("nan")
    assert torch.equal(dk.decode_attn_cuda(q, k, v, 700), clean)


def test_decode_attn_bf16_at_jamba_decode_shape(cuda):
    """jamba-1.5-large-398b's attention layer (B 16, S 2048, KV 8, G 8, hd
    128, bf16 cache) takes the tensor-core bf16 body in one wave of blocks
    of one KV head: within the bound of the plain version at pos 1087, one
    launch a call, bitwise repeatable; one captured call replayed at device
    positions equals eager calls bit for bit and the plain version; what
    lies past pos is never read; a device pos outside the cache gives NaN
    throughout, and the next replay is right."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    bf16 = torch.bfloat16
    assert dk.bf16_mma_body(bf16, False, 128, 8)
    kvg, split_len, nsplit = dk.launch_plan(cuda, bf16, False, 16, 8, 8,
                                            128, 2048)
    slots = dk._sm_count(cuda) * min(dk.MMA_BLOCKS_PER_SM, dk.blocks_per_sm(
        cuda, bf16, False, 128, 8))
    assert kvg == 1 and 16 * 8 * nsplit <= slots < 16 * 8 * (nsplit + 1)
    assert (nsplit - 1) * split_len < 2048 <= nsplit * split_len
    q, k, v = _attn_inputs(cuda, 16, 2048, 8, 8, 128, bf16, seed=2048)
    before = dk.LAUNCHES["decode_attn"]
    got = dk.decode_attn_cuda(q, k, v, 1087)
    assert dk.LAUNCHES["decode_attn"] == before + 1
    assert got.shape == (16, 8, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.cpu().numpy(), decode_attn_ref(q, k, v, 1087).cpu().numpy(),
        atol=1e-5, rtol=1e-4)
    for _ in range(3):
        assert torch.equal(dk.decode_attn_cuda(q, k, v, 1087), got)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    dk.decode_attn_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attn_cuda(q, k, v, pos)
    for p in (1087, 0, 255, 256, 1088, 2047):
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, dk.decode_attn_cuda(q, k, v, p))
        np.testing.assert_allclose(
            out.cpu().numpy(), decode_attn_ref(q, k, v, p).cpu().numpy(),
            atol=1e-5, rtol=1e-4)
    for bad in (2048, -1):
        pos.fill_(bad)
        graph.replay()
        assert bool(out.isnan().all())
    pos.fill_(1087)
    graph.replay()
    assert torch.equal(out, got)
    k[:, 1088:], v[:, 1088:] = float("inf"), float("nan")
    assert torch.equal(dk.decode_attn_cuda(q, k, v, 1087), got)


# the bf16 cache's body at G 1 on the tensor cores (walk_bf16_mma with a
# 96 KB ring; bf16 q and cache at hd 64 and 128): seamless-m4t-large-v2's
# hd 64, olmoe-1b-7b's hd 128, over many splits of one row
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_attn_tensor_core_bf16_g1_body(cuda, hd):
    """One KV head of one b (one row: a split for each slot of the wave,
    ~260 splits of 4500 positions merged in order) against the plain
    version at positions on and off the splits' and tiles' edges, one
    launch a call, bit for bit a second call; what lies past pos (inf and
    NaN) changes nothing; one captured call replayed at device positions
    equals eager calls bit for bit, and a device pos outside the cache
    gives NaN throughout."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    bf16 = torch.bfloat16
    assert dk.bf16_g1_body(bf16, False, hd, 1)
    q, k, v = _attn_inputs(cuda, 1, 4500, 1, 1, hd, bf16, seed=500 + hd)
    kvg, split_len, nsplit = dk.launch_plan(cuda, bf16, False, 1, 1, 1, hd,
                                            4500)
    assert kvg == 1 and nsplit > 100
    for p in (0, 15, 16, 63, 64, 127, 1087, 2222, 4499):
        before = dk.LAUNCHES["decode_attn"]
        got = dk.decode_attn_cuda(q, k, v, p)
        assert dk.LAUNCHES["decode_attn"] == before + 1
        np.testing.assert_allclose(
            got.cpu().numpy(), decode_attn_ref(q, k, v, p).cpu().numpy(),
            atol=1e-5, rtol=1e-4)
        assert torch.equal(dk.decode_attn_cuda(q, k, v, p), got)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    dk.decode_attn_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attn_cuda(q, k, v, pos)
    for p in (4499, 0, 63, 64, 1087):
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, dk.decode_attn_cuda(q, k, v, p))
    for bad in (4500, -1):
        pos.fill_(bad)
        graph.replay()
        assert bool(out.isnan().all())
    clean = dk.decode_attn_cuda(q, k, v, 700)
    k[:, 701:], v[:, 701:] = float("inf"), float("nan")
    assert torch.equal(dk.decode_attn_cuda(q, k, v, 700), clean)


@pytest.mark.parametrize("S,hd,pos", [(2048, 64, 1087),    # seamless self
                                      (1024, 64, 1023),    # seamless cross
                                      (2048, 128, 1087)])  # olmoe-1b-7b
def test_decode_attn_bf16_g1_at_decode_shapes(cuda, S, hd, pos):
    """seamless-m4t-large-v2's two decode shapes (B 16, KV 16, G 1, hd 64:
    its self layers at pos 1087, its cross layers over the 1,024 encoder
    positions) and olmoe-1b-7b's (hd 128) take walk_bf16_mma with one split
    a row in one wave of two blocks an SM: within the bound of the plain
    version, one launch a call, bitwise repeatable; one captured call
    replayed at device positions equals eager calls bit for bit; what lies
    past pos is never read; a device pos outside the cache gives NaN
    throughout, and the next replay is right."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    bf16 = torch.bfloat16
    assert dk.bf16_g1_body(bf16, False, hd, 1)
    assert dk.blocks_per_sm(cuda, bf16, False, hd, 1) >= 2
    kvg, split_len, nsplit = dk.launch_plan(cuda, bf16, False, 16, 16, 1, hd,
                                            S)
    assert (kvg, split_len, nsplit) == (1, S, 1)
    q, k, v = _attn_inputs(cuda, 16, S, 16, 1, hd, bf16, seed=S + hd)
    before = dk.LAUNCHES["decode_attn"]
    got = dk.decode_attn_cuda(q, k, v, pos)
    assert dk.LAUNCHES["decode_attn"] == before + 1
    assert got.shape == (16, 16, 1, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.cpu().numpy(), decode_attn_ref(q, k, v, pos).cpu().numpy(),
        atol=1e-5, rtol=1e-4)
    for _ in range(3):
        assert torch.equal(dk.decode_attn_cuda(q, k, v, pos), got)
    dev = torch.zeros(1, dtype=torch.int32, device=cuda)
    dk.decode_attn_cuda(q, k, v, dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attn_cuda(q, k, v, dev)
    for p in (pos, 0, 255, 256, S - 1):
        dev.fill_(p)
        graph.replay()
        assert torch.equal(out, dk.decode_attn_cuda(q, k, v, p))
        np.testing.assert_allclose(
            out.cpu().numpy(), decode_attn_ref(q, k, v, p).cpu().numpy(),
            atol=1e-5, rtol=1e-4)
    for bad in (S, -1):
        dev.fill_(bad)
        graph.replay()
        assert bool(out.isnan().all())
    dev.fill_(pos)
    graph.replay()
    assert torch.equal(out, got)
    if pos + 1 < S:
        k[:, pos + 1:], v[:, pos + 1:] = float("inf"), float("nan")
        assert torch.equal(dk.decode_attn_cuda(q, k, v, pos), got)


@pytest.mark.parametrize("S,pos", [(2048, 1087), (6404, 6403)])
def test_decode_attn_int8_at_llama_vision_decode_shapes(cuda, S, pos):
    """llama-3.2-vision-90b's two decode shapes on its int8 cache (B 16,
    KV 8, G 8, hd 128): its self layers' (S 2048, pos 1087) and its cross
    layers' (the 6,404 image tokens read whole) take the tensor-core body
    in one wave of blocks and match the plain version."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    bf16 = torch.bfloat16
    assert dk.mma_body(bf16, True, 128, 8)
    kvg, split_len, nsplit = dk.launch_plan(cuda, bf16, True, 16, 8, 8,
                                            128, S)
    slots = dk._sm_count(cuda) * min(dk.MMA_BLOCKS_PER_SM, dk.blocks_per_sm(
        cuda, bf16, True, 128, 8))
    assert 16 * 8 // kvg * nsplit <= slots
    assert (nsplit - 1) * split_len < S <= nsplit * split_len
    q, k, v = _int8_attn_inputs(cuda, 16, S, 8, 8, 128, bf16, seed=S)
    got = dk.decode_attn_cuda(q, k, v, pos)
    assert got.shape == (16, 8, 8, 128)
    np.testing.assert_allclose(
        got.cpu().numpy(), decode_attn_ref(q, k, v, pos).cpu().numpy(),
        atol=1e-5, rtol=1e-4)


def test_decode_attn_int8_at_moonshot_decode_shape(cuda):
    """moonshot-v1-16b-a3b's whole decode shape (B 16, S 2048, KV 16, G 1,
    hd 128, pos 1087) on its int8 cache, against the plain version."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _int8_attn_inputs(cuda, 16, 2048, 16, 1, 128, torch.bfloat16,
                                seed=13)
    got = decode_attn_cuda(q, k, v, 1087)
    assert got.shape == (16, 16, 1, 128)
    np.testing.assert_allclose(
        got.cpu().numpy(), decode_attn_ref(q, k, v, 1087).cpu().numpy(),
        atol=1e-5, rtol=1e-4)


def test_decode_attn_int8_at_yi_decode_shape(cuda):
    """yi-34b's decode shape (B 16, S 2048, KV 8, G 7, hd 128, pos 1087) on
    its int8 cache takes the tensor-core body (P V past G 4) and matches
    the plain version."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    assert dk.mma_body(torch.bfloat16, True, 128, 7)
    q, k, v = _int8_attn_inputs(cuda, 16, 2048, 8, 7, 128, torch.bfloat16,
                                seed=17)
    got = dk.decode_attn_cuda(q, k, v, 1087)
    assert got.shape == (16, 8, 7, 128)
    np.testing.assert_allclose(
        got.cpu().numpy(), decode_attn_ref(q, k, v, 1087).cpu().numpy(),
        atol=1e-5, rtol=1e-4)


# (arch, the reduced config's widening): yi-reduced at yi-34b's G 7 and
# hd 128 (7 heads over 1), qwen-reduced at qwen1.5-110b's G 8 and hd 128
# (8 over 1, its qkv biases), both on the int8 cache their full configs
# serve with
DENSE_ON_CARD = {"yi_34b": dict(n_heads=7, n_kv_heads=1, head_dim=128),
                 "qwen1_5_110b": dict(n_heads=8, n_kv_heads=1,
                                      head_dim=128)}


def _dense_serving_logits(cfg, models, prompt, steps_to_take=8):
    """The prefill's last logits and each decode step's of ``models``
    ({device: model}, the CPU's first), every model fed the CPU's greedy
    tokens -> {device: ((steps + 1, B, V) logits, (steps + 1, B) greedy
    tokens)} on the host."""
    from repro_torch.serve import steps

    outs, fed = {}, None
    P = prompt.shape[1]
    for dev, model in models.items():
        pre = steps.make_prefill_step(model, cfg, max_seq=P + steps_to_take)
        dec = steps.make_decode_step(model, cfg)
        cache, last = pre({"tokens": prompt.to(dev)})
        tok = torch.argmax(last[:, -1], -1).to(torch.int32)
        logits, toks = [last[:, -1]], [tok]
        for i in range(steps_to_take):
            given = tok if fed is None else fed[i].to(dev)
            cache, tok, lg = dec(cache, given[:, None], P + i)
            logits.append(lg[:, -1])
            toks.append(tok)
        outs[dev] = (torch.stack(logits).float().cpu(),
                     torch.stack(toks).cpu())
        fed = outs[dev][1]
    return outs


@pytest.mark.parametrize("arch", sorted(DENSE_ON_CARD))
def test_dense_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The serving steps of yi- and qwen-reduced (widened to their full
    configs' decode_attn shapes) on the card against the same weights on
    the CPU, both fed the CPU's greedy tokens, in fp32: on an fp32 cache
    the prefill's last logits and 8 decode steps' logits within 1e-4 of
    the largest |logit| (the CPU tests' bound), the same greedy token
    wherever the CPU's top two logits lie further apart than twice that;
    on the int8 cache (the full configs') within 5e-3, about eight times
    the worst seen on an H100 (6.06e-4: a K or V value whose fp32
    projections on the two devices straddle a rounding boundary quantizes
    one step apart), so that a quantize or dequantize fault on either
    device shows. Then in bf16
    on the int8 cache the decode steps launch the kernel at the full
    configs' G, on the tensor-core body, once a layer a step."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.models import DecoderLM

    prompt = None
    for cache_dtype, rel in (("bfloat16", 1e-4), ("int8", 5e-3)):
        # "bfloat16" names the cache of the compute type: fp32 here
        cfg = dataclasses.replace(get_reduced_config(arch),
                                  kv_cache_dtype=cache_dtype,
                                  **DENSE_ON_CARD[arch])
        cpu = DecoderLM(cfg, torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        card = DecoderLM(cfg, torch.float32, device=cuda, init=False)
        card.load_state_dict(cpu.state_dict())
        if prompt is None:
            prompt = torch.from_numpy(np.random.default_rng(3).integers(
                0, cfg.vocab_size, (4, 24)).astype(np.int32))
        outs = _dense_serving_logits(cfg, {"cpu": cpu, cuda: card}, prompt)
        (want, want_tok), (got, got_tok) = outs["cpu"], outs[cuda]
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= rel * scale, cache_dtype
        if cache_dtype == "bfloat16":
            top2 = torch.topk(want, 2).values
            clear = (top2[..., 0] - top2[..., 1]) > 2e-4 * scale
            assert bool(clear.any())
            assert torch.equal(got_tok[clear], want_tok[clear])
    G = cfg.n_heads // cfg.n_kv_heads
    assert dk.mma_body(torch.bfloat16, True, 128, G)
    bf16 = DecoderLM(cfg, torch.bfloat16, torch.bfloat16, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
    before = dk.LAUNCHES.get("decode_attn", 0)
    outs = _dense_serving_logits(cfg, {cuda: bf16}, prompt, 4)
    assert dk.LAUNCHES["decode_attn"] - before == 4 * cfg.n_layers
    assert bool(torch.isfinite(outs[cuda][0]).all())


@pytest.mark.parametrize("S,pos", [(2048, 1087), (1024, 1023)])
def test_decode_attn_at_seamless_decode_shapes(cuda, S, pos):
    """seamless-m4t-large-v2's two decode shapes on its bf16 caches (B 16,
    KV 16, G 1, hd 64): its self layers' (S 2048, pos 1087) and its cross
    layers' (the 1,024 encoder positions read whole), against the plain
    version."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    q, k, v = _attn_inputs(cuda, 16, S, 16, 1, 64, torch.bfloat16, seed=S)
    got = decode_attn_cuda(q, k, v, pos)
    assert got.shape == (16, 16, 1, 64)
    np.testing.assert_allclose(
        got.cpu().numpy(), decode_attn_ref(q, k, v, pos).cpu().numpy(),
        atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_step_graph_replays_as_the_eager_step(cuda, dtype):
    """A Mamba layer (d 256, N 16) on the card: its prefill within atol
    1e-5, rtol 1e-4 of the CPU's in fp32; a single-token step with the
    prefill's state, captured as a CUDA graph, replays bit for bit as the
    eager step (output and both states)."""
    from repro_torch.models.mamba import Mamba

    cpu = Mamba(256, 16, dtype=dtype, device="cpu")
    cpu.reset(torch.Generator().manual_seed(0))
    card = Mamba(256, 16, dtype=dtype, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 70, 256)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        out, st = card(x[:, :69].to(cuda))
        if dtype == torch.float32:
            want, wst = cpu(x[:, :69])
            np.testing.assert_allclose(out.cpu().numpy(), want.numpy(),
                                       atol=1e-5, rtol=1e-4)
            for key in ("conv", "ssm"):
                np.testing.assert_allclose(st[key].cpu().numpy(),
                                           wst[key].numpy(), atol=1e-5,
                                           rtol=1e-4)
        xs = x[:, 69:].to(cuda)
        eager, est = card(xs, state=st)
        static = {key: t.clone() for key, t in st.items()}
        card(xs, state=static)  # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed, gst = card(xs, state=static)
        graph.replay()
    assert torch.equal(replayed, eager)
    assert all(torch.equal(gst[key], est[key]) for key in est)


def test_encdec_graph_step_equals_the_eager_step(cuda):
    """seamless-reduced (bf16, hd 32) on the card: ``DecodeGraph``'s step
    replayed at the prompt's end gives the eager decode's logits bit for
    bit, from two prefills of the same prompt and frames; its capture
    records two ``decode_attn`` launches a decoder layer (self and
    cross)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.serve import DecodeGraph
    from repro_torch.models import EncDecLM

    cfg = get_reduced_config("seamless_m4t_large_v2")
    model = EncDecLM(cfg, torch.bfloat16, torch.bfloat16, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
    gen = torch.Generator(cuda).manual_seed(1)
    extras = {"frames": 0.3 * torch.randn(4, 48, cfg.d_model, device=cuda,
                                          generator=gen).to(torch.bfloat16)}
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 40)).astype(np.int32)).to(cuda)
    cache, last = model.prefill(prompts, extras, max_seq=64)
    tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)
    step = DecodeGraph(model, cache, tok, 40)
    assert step.launches == {"decode_attn": 2 * cfg.n_layers}
    step.replay(40)
    cache2, _ = model.prefill(prompts, extras, max_seq=64)
    _, eager = model.decode(cache2, tok[:, None], 40)
    assert torch.equal(step.logits, eager)


def _moe_pair(cuda, dtype, seed=0):
    """The same MoE on the CPU and on the card (olmoe-reduced's sizes)."""
    from repro_torch.models.moe import MoE

    cpu = MoE(128, 64, 8, 2, dtype=dtype, device="cpu")
    cpu.reset(torch.Generator().manual_seed(seed))
    card = MoE(128, 64, 8, 2, dtype=dtype, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("T", [(16, 1), (4, 64)])
def test_moe_on_the_card_matches_the_cpu(cuda, T):
    """fp32: the card's output within atol 1e-5 of the CPU's on the same
    weights and inputs, aux and drop within 1e-6; the same bits twice
    eagerly and from a captured CUDA graph (no atomics, no host sync)."""
    cpu, card = _moe_pair(cuda, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (*T, 128)).astype(np.float32))
    with torch.no_grad():
        want, (aux, drop) = cpu(x)
        xc = x.to(cuda)
        got, (caux, cdrop) = card(xc)
        again = card(xc)[0]
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed, _ = card(xc)
        graph.replay()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-4)
    assert abs(float(caux) - float(aux)) <= 1e-6
    assert abs(float(cdrop) - float(drop)) <= 1e-6
    assert torch.equal(again, got) and torch.equal(replayed, got)


def test_moe_on_the_card_keeps_tied_tokens_as_the_cpu(cuda):
    """One token repeated 24 times: every gate ties at each of its experts,
    which keep the lowest C token ids on the card as on the CPU."""
    cpu, card = _moe_pair(cuda, torch.float32, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 1, 128)).astype(np.float32)).expand(1, 24, 128).contiguous()
    with torch.no_grad():
        want = cpu(x)[0]
        got = card(x.to(cuda))[0].cpu()
    C = cpu.capacity(24)
    kept = torch.nonzero(got[0].abs().amax(-1) > 0).flatten()
    assert kept.tolist() == list(range(C))
    assert torch.equal(kept, torch.nonzero(
        want[0].abs().amax(-1) > 0).flatten())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("arch,int8", [("smollm_360m", False),
                                       ("rwkv6_1b6", False),
                                       ("stablelm_3b", True),
                                       ("olmoe_1b_7b", False),
                                       ("moonshot_v1_16b_a3b", True),
                                       ("llama3_2_vision_90b", False),
                                       ("llama3_2_vision_90b", True),
                                       ("jamba1_5_large_398b", False),
                                       ("seamless_m4t_large_v2", False),
                                       ("yi_34b", True),
                                       ("qwen1_5_110b", True)])
def test_graph_decode_equals_eager_decode(cuda, arch, int8):
    """The serving launcher's captured step replayed at every position gives
    the eager loop's tokens (reduced configs, bf16, random weights); the
    capture records one kernel launch per attention or RWKV layer, a
    VLM's cross layer's too (llama-vision-reduced at head dim 32: the
    kernel has no 16), two per decoder layer of an encoder-decoder (self
    and cross), and none for jamba's Mamba layers. qwen-reduced's head
    dim 16 is widened to 32 as llama-vision-reduced's."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ATTN, XATTN
    from repro_torch.launch.serve import serve_tokens
    from repro_torch.models import DecoderLM, EncDecLM

    cfg = get_reduced_config(arch)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    extras = {}
    if cfg.hd < 32:
        cfg = dataclasses.replace(cfg, head_dim=32)
    if cfg.cross_attn_every:
        extras["context"] = 0.3 * torch.randn(
            4, cfg.n_frontend_tokens, cfg.d_model, device=cuda,
            generator=torch.Generator(cuda).manual_seed(1)).to(torch.bfloat16)
    if cfg.enc_dec:
        extras["frames"] = 0.3 * torch.randn(
            4, 48, cfg.d_model, device=cuda,
            generator=torch.Generator(cuda).manual_seed(1)).to(torch.bfloat16)
    model = (EncDecLM if cfg.enc_dec else DecoderLM)(
        cfg, torch.bfloat16, torch.bfloat16, device=cuda,
        generator=torch.Generator(cuda).manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 40)).astype(np.int32)).to(cuda)
    eager = serve_tokens(model, prompts, 12, max_seq=64, graph=False,
                         extras=extras)
    graph = serve_tokens(model, prompts, 12, max_seq=64, graph=True,
                         extras=extras)
    assert eager.finite and graph.finite and eager.graph is None
    if cfg.attn_free:
        want = {"wkv6": cfg.n_layers}
    elif cfg.enc_dec:
        want = {"decode_attn": 2 * cfg.n_layers}
    else:
        want = {"decode_attn": cfg.n_blocks * sum(
            m in (ATTN, XATTN) for m, _ in cfg.block_pattern)}
    assert graph.graph.launches == want
    assert torch.equal(graph.tokens, eager.tokens)


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


# ---------------------------------------------------------------------------
# the single-stream engine's baselines and rate-controlled policy
# ---------------------------------------------------------------------------
def _engine_models(cuda):
    from repro_torch.core.accmodel import AccModel
    from repro_torch.vision.dnn import FinalDNN

    g = torch.Generator().manual_seed(0)
    return (FinalDNN("detection", 8, generator=g, device="cuda"),
            AccModel(8, generator=g, device="cuda"))


def test_controlled_prep_does_not_synchronise(cuda):
    """Setting knobs (a pinned, non-blocking copy) and applying them
    (``_controlled_prep``) never wait on the card, and give the CPU's
    frames, QP map and keep."""
    from repro_torch.control import RateController
    from repro_torch.control.controller import _controlled_prep

    frames = _frames(T=10)
    rng = np.random.RandomState(1)
    scores = rng.rand(1, 6, 10).astype(np.float32)
    ctrl = RateController()
    ctrl.level = 0.4
    chunk, sc = (torch.from_numpy(a).to(cuda) for a in (frames, scores))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    knobs = ctrl.knob_array(cuda)
    got = _controlled_prep(chunk, sc, knobs, gamma=2)
    torch.cuda.set_sync_debug_mode(0)
    want = _controlled_prep(torch.from_numpy(frames),
                            torch.from_numpy(scores),
                            ctrl.knob_array("cpu"), gamma=2)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("impl", ["fused", "fused_exact", "pallas"])
def test_baseline_policies_launch_the_engines_kernel(cuda, impl):
    """Every RoI encode of a baseline goes through the engine's backend:
    one chunk kernel a chunk (and one in the warm-up) under the fused
    backends, one frame kernel a sent frame under pallas, where
    Reducto+AccMPEG sends only its kept frames; uniform, Reducto and SiEVE
    encode with the plain exact scan and launch nothing. Per chunk,
    ``fused_exact`` and ``pallas`` bytes are within 1e-3 of ``exact``
    where the QP maps do not depend on the backend."""
    from repro_torch.control import (ControlledAccMPEGPolicy,
                                     RateController, lte_trace)
    from repro_torch.core.quality import QualityConfig
    from repro_torch.engine import (DDSPolicy, EAARPolicy,
                                    ReductoAccMPEGPolicy, ReductoPolicy,
                                    SiEVEPolicy, StreamingEngine,
                                    UniformPolicy, VigilPolicy,
                                    frame_diff_feature)

    dnn, am = _engine_models(cuda)
    frames = torch.from_numpy(_frames(T=20, seed=5)).to(cuda)
    feats = [frame_diff_feature(frames[s:s + 10]) for s in (0, 10)]
    thresh = float(torch.cat([f[1:] for f in feats]).median()) + 1e-6
    sent = sum(int((f >= thresh)[1:].sum()) + 1 for f in feats)
    assert 2 < sent < 20
    qcfg = QualityConfig(alpha=0.5, gamma=1)
    name = {"fused": tk.chunk_kernel_name(False),
            "fused_exact": tk.chunk_kernel_name(True),
            "pallas": "mbcodec_frame"}[impl]
    per_chunk = 10 if impl == "pallas" else 1
    cases = {
        "uniform": (lambda: UniformPolicy(38), 0),
        "reducto": (lambda: ReductoPolicy(thresh=thresh), 0),
        "sieve": (lambda: SiEVEPolicy(dnn, delta=1e-4), 0),
        "dds": (DDSPolicy, 3 * per_chunk),
        "eaar": (EAARPolicy, 3 * per_chunk),
        "vigil": (lambda: VigilPolicy(dnn), 3 * per_chunk),
        "reducto_accmpeg": (lambda: ReductoAccMPEGPolicy(am, qcfg, thresh),
                            per_chunk + (sent if impl == "pallas" else 2)),
    }
    for policy, launches in cases.values():
        before = tk.LAUNCHES[name]
        got = StreamingEngine(dnn, impl=impl).run(policy(), frames)
        assert tk.LAUNCHES[name] - before == launches
        if impl != "fused" and launches:
            want = StreamingEngine(dnn).run(policy(), frames)
            n = 1 if got.method == "eaar" else 2
            for g, w in zip(got.chunks[:n], want.chunks[:n]):
                assert g.bytes == pytest.approx(w.bytes, rel=1e-3)
    ctrl = RateController()
    before = tk.LAUNCHES[name]
    run = StreamingEngine(dnn, impl=impl, trace=lte_trace(),
                          controller=ctrl).run(
        ControlledAccMPEGPolicy(am, ctrl), frames)
    assert tk.LAUNCHES[name] - before == 3 * per_chunk
    assert len(ctrl.history) == 2 and all(c.bytes > 0 for c in run.chunks)


def _segmentation_models(device):
    from repro_torch.core.accmodel import AccModel
    from repro_torch.vision.dnn import FinalDNN

    g = torch.Generator().manual_seed(1)
    return (FinalDNN("segmentation", 8, generator=g, device=device),
            AccModel(8, generator=g, device=device))


@pytest.mark.parametrize("n_padded", [2, 4])
def test_masked_knob_camera_step_on_the_card(cuda, n_padded):
    """The closed loop's camera step (lane mask and knobs as device
    tensors) at two padded shapes: one scores launch a call, the mask and
    knobs set without a sync, padded lanes exactly 0 bytes, active lanes'
    bytes within rtol 1e-3 of the CPU's plain path."""
    from repro_torch.control import RateController
    from repro_torch.core.quality import QualityConfig
    from repro_torch.engine.multistream import _lane_flags
    from repro_torch.serve.steps import make_camera_fleet_step

    qcfg = QualityConfig(alpha=0.5, gamma=1)
    ctrl = RateController()
    ctrl.level = 0.3
    active = np.arange(n_padded) < n_padded - 1  # the last lane is padding
    chunks = np.stack([_frames(T=10, seed=s) for s in range(n_padded)])
    outs = {}
    for dev in ("cpu", "cuda"):
        am = _segmentation_models(dev)[1]
        step = make_camera_fleet_step(am, qcfg, impl="fused", knobs=True,
                                      mask=True)
        x = torch.from_numpy(chunks).to(dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        mask, knobs = _lane_flags(active, torch.device(dev)), \
            ctrl.knob_array(dev)
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode(0)
        name = tk.scores_kernel_name(False)
        before = tk.LAUNCHES[name]
        outs[dev] = [t.cpu() for t in step(x, mask, knobs)]
        assert tk.LAUNCHES[name] - before == (dev == "cuda")
    got, want = outs["cuda"], outs["cpu"]
    assert torch.equal(got[1][-1], torch.zeros_like(got[1][-1]))
    np.testing.assert_allclose(got[1][:-1].numpy(), want[1][:-1].numpy(),
                               rtol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=1e-5)


@pytest.mark.parametrize("task", ["segmentation", "keypoint"])
def test_device_lane_accuracy_on_the_card_matches_the_cpu(cuda, task):
    from repro_torch.vision.dnn import device_lane_accuracy

    rng = np.random.RandomState(4)
    key, c = {"segmentation": ("seg", 2), "keypoint": ("kp", 5)}[task]
    a = rng.randn(4, 10, 48, 80, c).astype(np.float32)
    b = a + 0.5 * rng.randn(*a.shape).astype(np.float32)
    got = device_lane_accuracy(task, {key: torch.from_numpy(a).to(cuda)},
                               {key: torch.from_numpy(b).to(cuda)})
    want = device_lane_accuracy(task, {key: torch.from_numpy(a)},
                                {key: torch.from_numpy(b)})
    assert got.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-6)


def test_serve_loop_launches_exactly_on_the_card(cuda):
    """Three intervals of windowed serving under churn (1, then 3 streams
    on 4 lanes, then 2 on the same 4): one scores launch an interval plus
    two for each new padded shape's warm-up (a step and a timed hot
    step), and a second schedule over the same shapes adds only its
    intervals' launches."""
    from repro_torch.control import ChurnEvent
    from repro_torch.core.quality import QualityConfig
    from repro_torch.engine import EngineConfig, MultiStreamEngine
    from repro_torch.obs import CompileCounter

    dnn, am = _segmentation_models("cuda")
    frames = np.stack([_frames(T=30, seed=s) for s in range(3)])
    eng = MultiStreamEngine(dnn, am, config=EngineConfig(
        qcfg=QualityConfig(alpha=0.5, gamma=1), impl="fused",
        detail="windowed", sim_encode_s=0.05))
    name = tk.scores_kernel_name(False)
    before = tk.LAUNCHES[name]
    res = eng.serve_loop(frames, initial=(0,), events=[
        ChurnEvent(1, join=(1, 2)), ChurnEvent(2, leave=(0,))],
        rescale=False)
    assert res.shapes == [1, 4] and res.served_cis == [0, 1, 2]
    assert tk.LAUNCHES[name] - before == 3 + 2 * 2
    assert res.aggregate.n == 1 + 3 + 2
    assert 0.0 <= res.accuracy <= 1.0 and res.aggregate.sum_bytes > 0
    counter = CompileCounter.for_engine(eng)
    before = tk.LAUNCHES[name]
    eng.serve_loop(frames, initial=(0, 1, 2), events=[
        ChurnEvent(1, leave=(1, 2))], rescale=False)
    assert tk.LAUNCHES[name] - before == 3
    counter.assert_no_recompiles("second schedule")


def _tenant_models(device):
    """Three tenants (detection, segmentation, keypoint) of width 8, each
    with its own AccModel, and their quality configs."""
    from repro_torch.core.accmodel import AccModel
    from repro_torch.core.quality import QualityConfig
    from repro_torch.serve.tenants import TenantSpec
    from repro_torch.vision.dnn import FinalDNN

    g = torch.Generator().manual_seed(7)
    q = QualityConfig(alpha=0.5, gamma=1)
    return tuple(TenantSpec(task, FinalDNN(task, 8, generator=g,
                                           device=device),
                            AccModel(8, generator=g, device=device), qcfg=q)
                 for task in ("detection", "segmentation", "keypoint"))


def test_tenant_server_step_on_the_card_matches_sequential(exact_convs):
    """The grouped server step (each tenant's DNN once over its own lanes)
    against each lane's own tenant's DNN run alone, on the card, TF32 off:
    within 1e-5; the tenant-id lane set without a sync, foreign keys 0."""
    from repro_torch.serve.steps import (TenantLanes,
                                         make_tenant_server_fleet_step)
    from repro_torch.serve.tenants import TASK_KEYS
    from repro_torch.vision.dnn import detection_keep_heat

    tenants = _tenant_models("cuda")
    decoded = torch.from_numpy(np.stack([_frames(T=10, seed=s)
                                         for s in range(6)])).cuda()
    ids = np.array([2, 0, 1, 0, 2, 2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    lanes = TenantLanes(ids, len(tenants), torch.device("cuda"))
    torch.cuda.set_sync_debug_mode(0)
    out = make_tenant_server_fleet_step(tenants)(decoded, lanes)
    assert set(out) == {"heat", "wh", "off", "keep", "seg", "kp"}
    for lane, t in enumerate(ids):
        spec = tenants[t]
        seq = spec.dnn.predict(decoded[lane])
        if spec.task == "detection":
            seq["keep"] = detection_keep_heat(seq)
        for k in TASK_KEYS[spec.task]:
            np.testing.assert_allclose(out[k][lane].cpu().numpy(),
                                       seq[k].cpu().numpy(), atol=1e-5,
                                       err_msg=k)
        for k in set(out) - set(TASK_KEYS[spec.task]):
            assert float(out[k][lane].abs().max()) == 0.0


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_mixed_tenant_churn_on_the_card_builds_nothing_new(cuda, impl):
    """Two tenants under churn on the card: one kernel launch an interval
    per padded shape's rule (the scores kernel under fused, one frame
    launch a padded lane-frame under pallas), and a second schedule with
    other tenant mixes on the same shapes builds and warms nothing."""
    from repro_torch.control import ChurnEvent
    from repro_torch.core.quality import QualityConfig
    from repro_torch.engine import EngineConfig, MultiStreamEngine
    from repro_torch.obs import CompileCounter
    from repro_torch.serve.tenants import TenantSpec

    seg, kp = _tenant_models("cuda")[1:]
    if impl == "pallas":  # its own QP ladder per tenant
        kp = TenantSpec(kp.name, kp.dnn, kp.accmodel,
                        qcfg=QualityConfig(alpha=0.5, gamma=1, qp_lo=51))
    frames = np.stack([_frames(T=30, seed=s) for s in range(4)])
    eng = MultiStreamEngine(config=EngineConfig(
        impl=impl, detail="windowed", sim_encode_s=0.05, tenants=(seg, kp),
        tenant_of={0: 0, 1: 1, 2: 0, 3: 1}))
    name = tk.scores_kernel_name(False) if impl == "fused" \
        else "mbcodec_frame"
    per_step = {2: 1, 4: 1} if impl == "fused" else {2: 20, 4: 40}
    before = tk.LAUNCHES[name]
    res = eng.serve_loop(frames, initial=(0, 1), events=[
        ChurnEvent(1, join=(2, 3)), ChurnEvent(2, leave=(1, 3))],
        rescale=False)
    assert res.shapes == [2, 4]
    # 3 intervals on shapes 2, 4, 2, and two warm-up steps for each shape
    assert tk.LAUNCHES[name] - before == \
        3 * per_step[2] + 3 * per_step[4] + per_step[2]
    assert res.aggregate.n == 2 + 4 + 2 and eng._acc_step is not None
    acc = res.accuracy_by_tenant()
    assert all(0.0 <= a <= 1.0 for a in acc)
    counter = CompileCounter.for_engine(eng)
    before = tk.LAUNCHES[name]
    eng.serve_loop(frames, initial=(1, 3), events=[
        ChurnEvent(1, join=(0, 2)), ChurnEvent(2, leave=(0, 2))],
        rescale=False)
    assert tk.LAUNCHES[name] - before == 2 * per_step[2] + per_step[4]
    counter.assert_no_recompiles("a second tenant mix")
