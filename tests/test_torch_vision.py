"""The port's vision layer and quality assignment against the reference:
``FinalDNN`` outputs and ``AccModel`` scores with the reference's weights
carried across by ``repro_torch.weights``, host scoring on identical
outputs, and the dilation / QP-map helpers.

Network outputs: atol 1e-4 (float32 convolutions summed in another order
by XLA and by PyTorch's CPU kernels). Host scoring and the QP helpers see
identical inputs and must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accmodel as jam
from repro.core import quality as jq
from repro.vision import dnn as jv
from repro.vision.train import _flatten
from repro_torch.core import accmodel as tam
from repro_torch.core import quality as tq
from repro_torch.vision import dnn as tv
from repro_torch.weights import accmodel_from_numpy, final_dnn_from_numpy

NET_ATOL = 1e-4
H, W, WIDTH = 96, 160, 8


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _frames(B=2, seed=0):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


@pytest.mark.parametrize("task", ["detection", "segmentation", "keypoint"])
def test_final_dnn_matches_reference(task):
    params = jv.init_net(task, jax.random.PRNGKey(3), WIDTH)
    frames = _frames()
    want = jv.FinalDNN(task, params).predict(jnp.asarray(frames))
    net = final_dnn_from_numpy(task, _np_tree(params), device="cpu")
    got = net.predict(torch.from_numpy(frames))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=NET_ATOL, err_msg=k)


def test_flat_npz_form_loads_the_same_weights():
    params = jv.init_net("detection", jax.random.PRNGKey(4), WIDTH)
    nested = final_dnn_from_numpy("detection", _np_tree(params), device="cpu")
    flat = final_dnn_from_numpy("detection", _flatten(params), device="cpu")
    for (k, a), (k2, b) in zip(nested.state_dict().items(),
                               flat.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    assert nested.width == WIDTH
    assert tuple(nested.backbone.b1.dw.weight.shape) == (WIDTH // 2, 1, 3, 3)


@pytest.mark.parametrize("width", [4, 8])
def test_accmodel_scores_match_reference(width):
    params = jam.accmodel_init(jax.random.PRNGKey(5), width)
    frames = _frames(3, seed=1)
    want = np.asarray(jam.AccModel(params).scores(jnp.asarray(frames)))
    model = accmodel_from_numpy(_np_tree(params), device="cpu")
    got = model.scores(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (3, H // 16, W // 16)
    np.testing.assert_allclose(got, want, atol=NET_ATOL)
    assert tam.accmodel_flops(H, W, width) == jam.accmodel_flops(H, W, width)


@pytest.mark.parametrize("n,k,stride", [(10, 3, 2), (9, 3, 2), (12, 3, 1),
                                        (7, 1, 1), (16, 3, 2)])
def test_same_padding_matches_xla(n, k, stride):
    """SAME padding for odd and even sizes, stride 1 and 2: XLA pads
    stride-2 3x3 convs on even inputs (0, 1)."""
    rng = np.random.RandomState(n)
    x = rng.rand(1, n, n + 2, 3).astype(np.float32)
    p = jv.conv_init(jax.random.PRNGKey(n), k, k, 3, 4)
    want = np.asarray(jv.conv(p, jnp.asarray(x), stride=stride))
    conv = tv.Conv(k, 3, 4, stride)
    w_oihw = np.asarray(p["w"]).transpose(3, 2, 0, 1).copy()
    conv.weight.data = torch.from_numpy(w_oihw)
    got = tv.to_nhwc(conv(tv.to_nchw(torch.from_numpy(x)))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _spread_outputs(seed=6, B=3):
    """Detection-shaped outputs with heat logits spread over (-4, 4)."""
    rng = np.random.RandomState(seed)
    hs, ws = H // 8, W // 8
    return {"heat": (8 * rng.rand(B, hs, ws, 1) - 4).astype(np.float32),
            "wh": (6 * rng.rand(B, hs, ws, 2)).astype(np.float32),
            "off": rng.rand(B, hs, ws, 2).astype(np.float32)}


def test_detection_nms_and_scoring_match():
    out, ref = _spread_outputs(6), _spread_outputs(7)
    j = lambda o: {k: jnp.asarray(v) for k, v in o.items()}
    t = lambda o: {k: torch.from_numpy(v) for k, v in o.items()}
    np.testing.assert_allclose(tv.detection_keep_heat(t(out)).numpy(),
                               np.asarray(jv.detection_keep_heat(j(out))),
                               atol=1e-6)
    assert tv.decode_detections(t(out)) == jv.decode_detections(j(out))
    net = tv.FinalDNN("detection", WIDTH, device="cpu")
    acc_t = net.accuracy(t(out), t(ref))
    acc_j = jv.FinalDNN("detection", {}).accuracy(j(out), j(ref))
    assert acc_t == acc_j and 0.0 < acc_t < 1.0


@pytest.mark.parametrize("task,key,c", [("segmentation", "seg", 2),
                                        ("keypoint", "kp", 5)])
def test_dense_task_scoring_matches(task, key, c):
    rng = np.random.RandomState(8)
    out, ref = (rng.randn(2, 12, 20, c).astype(np.float32) for _ in range(2))
    acc_t = tv.FinalDNN(task, WIDTH, device="cpu").accuracy(
        {key: torch.from_numpy(out)}, {key: torch.from_numpy(ref)})
    acc_j = jv.FinalDNN(task, {}).accuracy({key: jnp.asarray(out)},
                                           {key: jnp.asarray(ref)})
    assert acc_t == acc_j


@pytest.mark.parametrize("gamma", [0, 1, 2, 5])
def test_dilation_and_qp_map_match(gamma):
    scores = np.random.RandomState(gamma).rand(2, 6, 10).astype(np.float32)
    np.testing.assert_array_equal(
        tq.dilate_scores(torch.from_numpy(scores), gamma).numpy(),
        np.asarray(jq.dilate_scores(jnp.asarray(scores), gamma)))
    cfg = jq.QualityConfig(alpha=0.7, gamma=gamma, qp_hi=30, qp_lo=42)
    cfg_t = tq.QualityConfig(alpha=0.7, gamma=gamma, qp_hi=30, qp_lo=42)
    for s in scores:  # 2-D maps, as the policy uses them
        q_j, m_j = jq.qp_map_from_scores(jnp.asarray(s), cfg)
        q_t, m_t = tq.qp_map_from_scores(torch.from_numpy(s), cfg_t)
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    mask = torch.from_numpy(scores > 0.8)
    np.testing.assert_array_equal(
        tq.dilate(mask, gamma).numpy(),
        np.asarray(jq.dilate(jnp.asarray(scores > 0.8), gamma)))
