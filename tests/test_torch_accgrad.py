"""The port's AccGrad reduction and ``core/accgrad.py`` against the
reference on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
Tolerances: the plain reduction against the reference's jnp oracle and
its Pallas kernel in interpret mode, rtol 1e-5 (the same sums of
non-negative float32 terms in another order); AccGrad grids, which add a
gradient through the final DNN whose convolutions XLA and PyTorch sum in
other orders, atol 1e-5 on grids normalised to [0, 1]. Random-init heads
give nearly flat outputs, where the proxy's gradient is a difference of
two nearly equal numbers (a segmentation softmax of ~0.5 against D(H)'s
~0.5) and float order alone moves it by ~4e-5 of its largest entry; so,
as in ``tests/test_torch_engine.py``, the heads' last layers are scaled
(x100) to spread their logits to a trained net's range, and both packages
get the same scaled weights.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accgrad as jag
from repro.kernels.accgrad_reduce.kernel import accgrad_reduce_pallas
from repro.kernels.accgrad_reduce.ref import accgrad_reduce_ref as j_ref
from repro.vision import dnn as jv
from repro_torch.core import accgrad as tag
from repro_torch.kernels import build
from repro_torch.kernels.accgrad_reduce import kernel as tk
from repro_torch.kernels.accgrad_reduce.ops import accgrad_reduce
from repro_torch.kernels.accgrad_reduce.ref import accgrad_reduce_ref
from repro_torch.weights import final_dnn_from_numpy

REDUCE_RTOL = 1e-5
GRID_ATOL = 1e-5
SHAPES = [(32, 32, 1), (64, 96, 3), (16, 160, 3)]  # tests/test_kernels.py


def spread_heads(params):
    """The reference's ``params`` as numpy, every head's last layer x100."""
    params = jax.tree_util.tree_map(np.asarray, params)
    for name in params:
        if name != "backbone":
            params[name]["c2"]["w"] = params[name]["c2"]["w"] * 100.0
    return params


def _inputs(shape, seed, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return [rng.standard_normal(lead + shape).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_reduction_matches_reference_per_frame(shape):
    g, hq, lq = _inputs(shape, shape[0])
    got = accgrad_reduce_ref(*map(torch.from_numpy, (g, hq, lq))).numpy()
    want = np.asarray(j_ref(g, hq, lq))
    pallas = np.asarray(accgrad_reduce_pallas(
        jnp.asarray(g), jnp.asarray(hq), jnp.asarray(lq), interpret=True))
    assert got.shape == want.shape == (shape[0] // 16, shape[1] // 16)
    np.testing.assert_allclose(got, want, rtol=REDUCE_RTOL)
    np.testing.assert_allclose(got, pallas, rtol=REDUCE_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_reduction_batched_matches_reference_per_frame(shape):
    g, hq, lq = _inputs(shape, shape[1], batch=3)
    got = accgrad_reduce(*map(torch.from_numpy, (g, hq, lq))).numpy()
    assert got.shape == (3, shape[0] // 16, shape[1] // 16)
    for b in range(3):
        np.testing.assert_allclose(got[b], np.asarray(j_ref(g[b], hq[b],
                                                            lq[b])),
                                   rtol=REDUCE_RTOL)
        one = accgrad_reduce(*(torch.from_numpy(x[b]) for x in (g, hq, lq)))
        np.testing.assert_allclose(got[b], one.numpy(), rtol=REDUCE_RTOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    g, hq, lq = map(torch.from_numpy, _inputs((32, 48, 3), 7, batch=2))
    before = dict(tk.LAUNCHES)
    assert torch.equal(accgrad_reduce(g, hq, lq),
                       accgrad_reduce_ref(g, hq, lq))
    assert dict(tk.LAUNCHES) == before


def test_kernel_wrapper_refuses_cpu_and_malformed_tensors():
    g, hq, lq = map(torch.from_numpy, _inputs((32, 48, 3), 8, batch=2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.accgrad_reduce_cuda(g, hq, lq)
    # a tensor on any device but CUDA, the CPU and meta raises (a stand-in:
    # this host makes tensors on no other device)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        accgrad_reduce(types.SimpleNamespace(device=torch.device("xpu")),
                       hq, lq)
    # meta tensors (the dry-run's counting pass) take the plain version:
    # its shapes, and no launch
    before = dict(tk.LAUNCHES)
    out = accgrad_reduce(g.to("meta"), hq.to("meta"), lq.to("meta"))
    assert out.device.type == "meta"
    assert out.shape == accgrad_reduce_ref(g, hq, lq).shape
    assert dict(tk.LAUNCHES) == before


def test_library_is_registered_for_the_build():
    assert build.SOURCES["accgrad_reduce"] == \
        "accgrad_reduce/csrc/accgrad_reduce.cu"
    assert (build.KERNELS_DIR / build.SOURCES["accgrad_reduce"]).exists()
    path = build.library_path("accgrad_reduce")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libaccgrad_reduce-")
    assert path != build.library_path("mbcodec")


# ---------------------------------------------------------------------------
# core/accgrad.py
# ---------------------------------------------------------------------------
class _Linear:
    """D(x) = <w, x> with a squared-error proxy, the reference tests'
    analytic final DNN, in either package's arrays."""

    def __init__(self, w, xp):
        self.w, self.xp = w, xp

    def predict(self, frames):
        return {"y": self.xp.einsum("bhwc,hwc->b", frames, self.w)}

    def proxy_loss(self, frames, ref):
        y = self.xp.einsum("bhwc,hwc->b", frames, self.w)
        if self.xp is torch:
            return ((y - ref["y"].detach()) ** 2).sum()
        return jnp.sum((y - jax.lax.stop_gradient(ref["y"])) ** 2)


def test_accgrad_linear_case_matches_reference():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((32, 48, 3)).astype(np.float32)
    hq = rng.random((2, 32, 48, 3), dtype=np.float32)
    lq = hq.copy()
    lq[:, :16] += 0.1  # only the top macroblock row differs
    got = tag.accgrad_frames(_Linear(torch.from_numpy(w), torch),
                             torch.from_numpy(hq), torch.from_numpy(lq))
    want = jag.accgrad_frames(_Linear(jnp.asarray(w), jnp), jnp.asarray(hq),
                              jnp.asarray(lq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRID_ATOL)
    assert float(got[:, 1:].max()) == 0.0  # H == L there
    assert float(got[:, 0].max()) == 1.0   # normalised per frame


@pytest.mark.parametrize("task", ["detection", "segmentation", "keypoint"])
def test_accgrad_frames_matches_reference(task):
    """The same hq / lq and the same weights in both packages."""
    params = spread_heads(jv.init_net(task, jax.random.PRNGKey(6), 8))
    rng = np.random.default_rng(3)
    hq = rng.random((2, 64, 96, 3), dtype=np.float32)
    lq = np.clip(hq + 0.05 * rng.standard_normal(hq.shape), 0, 1).astype(
        np.float32)
    want = jag.accgrad_frames(
        jv.FinalDNN(task, jax.tree_util.tree_map(jnp.asarray, params)),
        jnp.asarray(hq), jnp.asarray(lq))
    net = final_dnn_from_numpy(task, params, device="cpu")
    got = tag.accgrad_frames(net, torch.from_numpy(hq), torch.from_numpy(lq))
    assert got.shape == (2, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRID_ATOL)
    # the gradient came from torch.autograd.grad: no parameter kept one
    assert all(p.grad is None for p in net.parameters())


def test_accgrad_zero_where_equal():
    rng = np.random.default_rng(4)
    params = jv.init_net("detection", jax.random.PRNGKey(7), 8)
    net = final_dnn_from_numpy(
        "detection", jax.tree_util.tree_map(np.asarray, params), device="cpu")
    hq = torch.from_numpy(rng.random((2, 32, 48, 3), dtype=np.float32))
    assert float(tag.accgrad_frames(net, hq, hq.clone()).abs().max()) == 0.0


def test_block_reduce_and_embeddings_match_reference():
    rng = np.random.default_rng(5)
    x = rng.random((2, 32, 64), dtype=np.float32)
    np.testing.assert_allclose(tag.block_reduce(torch.from_numpy(x)).numpy(),
                               np.asarray(jag.block_reduce(jnp.asarray(x))),
                               rtol=REDUCE_RTOL)
    hq = rng.standard_normal((2, 18, 8)).astype(np.float32)
    lq = (hq + 0.1 * rng.standard_normal(hq.shape)).astype(np.float32)
    for group in (1, 4):
        got = tag.accgrad_embeddings(lambda e: (e ** 2).sum(),
                                     torch.from_numpy(hq),
                                     torch.from_numpy(lq), group=group)
        want = jag.accgrad_embeddings(lambda e: jnp.sum(e ** 2),
                                      jnp.asarray(hq), jnp.asarray(lq),
                                      group=group)
        assert got.shape == want.shape == (2, 18 // group)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRID_ATOL)
