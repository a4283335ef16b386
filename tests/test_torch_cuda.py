"""The port's CUDA kernels on a card, against their plain versions.

This file imports no JAX, so it runs on a CUDA host without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Elsewhere every test skips. Tolerances: decoded atol 1e-5 and bits rtol
1e-4 in blocks where no quantized coefficient flips; round-half flips
between the kernel's and cuBLAS's float orders at most 1e-4 of the
coefficients; through the codec backends, where a flip moves its
macroblock for the rest of the chunk, at most 2 of 60 macroblocks off by
more than 1e-5; bytes per frame rtol 1e-3. The scores kernel against the
explicit-array kernel fed the implied QP map: bit-equal (one
``encode_block`` body). ``accgrad_reduce`` against its plain version:
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
