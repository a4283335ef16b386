"""The port's offline training path against the reference on the CPU:
``proxy_loss`` and the final DNNs' training losses, AccGrad labels, the
weighted BCE, the reference's Adam, both AccModel trainers and
``train_final_dnn``.

Frames are the dashcam scene generator's (96x160), weights the
reference's, carried across by ``repro_torch.weights``. Random-init heads
give nearly flat outputs, where the proxy's gradient is a difference of
nearly equal numbers and float order alone moves it (see
``tests/test_torch_accgrad.py``), so every head's last layer is scaled
x100 and both packages get the same scaled weights. Initial weights of
the trainers are shared by patching the reference's
``repro.core.training.accmodel_init`` / ``repro.vision.dnn.init_net`` and
the port's ``accmodel_init`` / ``init_net`` with ``monkeypatch``; both
``train_final_dnn`` run with ``cache=False``, so nothing is read from or
written to a model cache.

Tolerances, each for float32 sums taken in another order by XLA and by
PyTorch's CPU kernels: losses rtol 1e-5; input and parameter gradients
within 1e-4 of the tensor's largest entry; weights after a few Adam steps
atol 1e-6 (the update is about lr * sign(g), so float order moves a
weight by ulps, unless a gradient's sign flips: see
``test_adam_step_matches_reference``); AccModel scores atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec.codec import encode_chunk_uniform as j_encode_uniform
from repro.core import accgrad as jag
from repro.core import accmodel as jam
from repro.core import training as jtr
from repro.data.video import make_scene
from repro.vision import dnn as jv
from repro.vision import train as jvt
from repro.vision.train import _flatten
from repro_torch.codec.codec import encode_chunk_uniform as t_encode_uniform
from repro_torch.core import training as ttr
from repro_torch.vision import dnn as tv
from repro_torch.vision import train as tvt
from repro_torch.weights import (accmodel_from_numpy, accmodel_to_numpy,
                                 final_dnn_from_numpy, final_dnn_to_numpy,
                                 flat_numpy)

H, W, WIDTH = 96, 160, 8
TASKS = ["detection", "segmentation", "keypoint"]
LOSS_RTOL, GRAD_REL, WEIGHT_ATOL, SCORE_ATOL = 1e-5, 1e-4, 1e-6, 1e-5
# dashcam scene whose AccGrad labels are well posed: see
# test_label_seed_is_well_posed
LABEL_SEED, LABEL_ALPHA, LABEL_MARGIN = 51, 0.1, 1e-4


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


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jnp_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _spread(params):
    params = _np_tree(params)
    for name in params:
        if name != "backbone":
            params[name]["c2"]["w"] = params[name]["c2"]["w"] * 100.0
    return params


def _assert_close_rel(got: dict, want: dict, rel=GRAD_REL):
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= rel * scale, k


@pytest.fixture(scope="module")
def nets():
    """{task: numpy params} for the three final DNNs, heads spread."""
    return {task: _spread(jv.init_net(task, jax.random.PRNGKey(i + 2),
                                      WIDTH))
            for i, task in enumerate(TASKS)}


@pytest.fixture(scope="module")
def scene():
    return make_scene("dashcam", seed=LABEL_SEED, T=8, H=H, W=W)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("task", TASKS)
def test_proxy_loss_value_and_input_gradient(task, nets):
    rng = np.random.default_rng(10)
    hq = rng.random((2, 64, 96, 3), dtype=np.float32)
    lq = np.clip(hq + 0.1 * rng.standard_normal(hq.shape), 0, 1).astype(
        np.float32)
    jd = jv.FinalDNN(task, _jnp_tree(nets[task]))
    ref = jd.predict(jnp.asarray(hq))
    want_l, want_g = jax.value_and_grad(
        lambda x: jd.proxy_loss(x, ref))(jnp.asarray(lq))
    td = final_dnn_from_numpy(task, nets[task], device="cpu")
    x = torch.from_numpy(lq).requires_grad_(True)
    got_l = td.proxy_loss(x, td.predict(torch.from_numpy(hq)))
    (got_g,) = torch.autograd.grad(got_l, x)
    assert float(got_l.detach()) == pytest.approx(float(want_l),
                                                 rel=LOSS_RTOL)
    _assert_close_rel({"x": got_g.numpy()}, {"x": np.asarray(want_g)})
    assert all(p.grad is None for p in td.parameters())


def _train_targets(task, scene_):
    """Both packages' targets for ``scene_``; the rendering is the same
    numpy code, so they must be equal."""
    if task == "detection":
        want = jv.render_detection_targets(scene_.boxes, H, W)
        got = tv.render_detection_targets(scene_.boxes, H, W, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return tuple(want), got, jv.detection_train_loss, \
            tv.detection_train_loss
    if task == "segmentation":
        seg = scene_.masks[:, ::jv.STRIDE, ::jv.STRIDE].astype(np.int32)
        return jnp.asarray(seg), torch.from_numpy(seg), \
            jv.segmentation_train_loss, tv.segmentation_train_loss
    want = jv.render_kp_targets(scene_.keypoints, H, W)
    got = tv.render_kp_targets(scene_.keypoints, H, W, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return want, got, jv.keypoint_train_loss, tv.keypoint_train_loss


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("genre", ["dashcam", "surf"])
def test_train_loss_value_and_parameter_gradient(task, genre, nets):
    sc = make_scene(genre, seed=3, T=4, H=H, W=W)
    j_t, t_t, j_loss, t_loss = _train_targets(task, sc)
    params = _jnp_tree(nets[task])
    want_l, want_g = jax.value_and_grad(
        lambda p: j_loss(p, jnp.asarray(sc.frames), j_t))(params)
    td = final_dnn_from_numpy(task, nets[task], device="cpu")
    names = [n for n, _ in td.named_parameters()]
    got_l = t_loss(td, torch.from_numpy(sc.frames), t_t)
    grads = torch.autograd.grad(got_l, list(td.parameters()),
                                allow_unused=True, materialize_grads=True)
    assert float(got_l.detach()) == pytest.approx(float(want_l),
                                                 rel=LOSS_RTOL)
    _assert_close_rel(flat_numpy(dict(zip(names, grads))),
                      _flatten(_np_tree(want_g)))


def test_weighted_bce_matches_reference():
    rng = np.random.default_rng(11)
    logits = (4 * rng.standard_normal((3, 6, 10))).astype(np.float32)
    labels = rng.random((3, 6, 10)) < 0.3
    for pos_weight in (1.0, 4.0):
        want = jtr.weighted_bce(jnp.asarray(logits), jnp.asarray(labels),
                                pos_weight)
        got = ttr.weighted_bce(torch.from_numpy(logits),
                               torch.from_numpy(labels), pos_weight)
        assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


def test_adam_step_matches_reference(scene):
    """One step of the port's Adam against the reference's
    ``_adam_trainer`` on the same AccModel loss. At step 0, m = 0.1 g and
    sqrt(v) = 0.1 |g|, so the update is lr_t * g / (|g| + 1e-7): about
    lr_t * sign(g) wherever |g| >> 1e-7. A gradient entry within float
    noise of 0 (|g| < 1e-6 max |g|) can take the other sign in the other
    float order and move its weight by up to 2 lr_t; everywhere else the
    weights agree within WEIGHT_ATOL."""
    params = _np_tree(jam.accmodel_init(jax.random.PRNGKey(4), WIDTH))
    frames = scene.frames[:4]
    labels = np.random.default_rng(12).random((4, H // 16, W // 16)) < 0.3

    def loss_fn(p, f, y):
        return jtr.weighted_bce(jam.accmodel_apply(p, f), y)

    step, m, v = jtr._adam_trainer(loss_fn, _jnp_tree(params))
    g_want = _flatten(_np_tree(jax.grad(loss_fn)(
        _jnp_tree(params), jnp.asarray(frames), jnp.asarray(labels))))
    want, *_ = step(_jnp_tree(params), m, v, 0, jnp.asarray(frames),
                    jnp.asarray(labels))
    want = _flatten(_np_tree(want))

    model = accmodel_from_numpy(params, device="cpu")
    plist = list(model.parameters())
    loss = ttr.weighted_bce(model(torch.from_numpy(frames)),
                            torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, plist)
    tm, tv_ = ttr.adam_state(plist)
    ttr.adam_update(plist, grads, tm, tv_, 0, ttr.ACCMODEL_LR,
                    ttr.ACCMODEL_WARMUP)
    got = accmodel_to_numpy(model)
    lr_t = ttr.ACCMODEL_LR / ttr.ACCMODEL_WARMUP
    assert set(got) == set(want)
    moved = 0
    for k in want:
        tiny = np.abs(g_want[k]) < 1e-6 * np.abs(g_want[k]).max()
        diff = np.abs(got[k] - want[k])
        assert diff[~tiny].max(initial=0.0) <= WEIGHT_ATOL, k
        assert diff[tiny].max(initial=0.0) <= 2 * lr_t + WEIGHT_ATOL, k
        moved += int((np.abs(got[k] - _flatten(params)[k]) > 0.5 * lr_t).sum())
    assert moved > 0.9 * sum(v.size for v in want.values())


# ---------------------------------------------------------------------------
# labels and trainers
# ---------------------------------------------------------------------------
def test_label_seed_is_well_posed(nets, scene):
    """No normalised AccGrad of the reference lies within 1e-4 of
    ``label_alpha`` (where float order could flip a label), and the two
    packages' exact codecs agree on every hq / lq pixel within 1e-5 (no
    round-half flip, which moves a pixel by a quantization step). Seeds
    53 and 55 have AccGrad within 5e-5 of alpha."""
    jd = jv.FinalDNN("detection", _jnp_tree(nets["detection"]))
    for i in range(0, 8, 4):
        chunk = scene.frames[i:i + 4]
        hq, _ = j_encode_uniform(jnp.asarray(chunk), 30)
        lq, _ = j_encode_uniform(jnp.asarray(chunk), 40)
        for want, qp in ((hq, 30), (lq, 40)):
            got, _ = t_encode_uniform(torch.from_numpy(chunk), qp)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
        ag = np.asarray(jag.accgrad_frames(jd, hq, lq))
        assert np.abs(ag - LABEL_ALPHA).min() > LABEL_MARGIN
        assert 0.05 < (ag >= LABEL_ALPHA).mean() < 0.95


def test_make_labels_matches_reference(nets, scene):
    want_hq, want = jtr.make_labels(
        jv.FinalDNN("detection", _jnp_tree(nets["detection"])),
        scene.frames, 30, 40, label_alpha=LABEL_ALPHA)
    td = final_dnn_from_numpy("detection", nets["detection"], device="cpu")
    got_hq, got = ttr.make_labels(td, scene.frames, 30, 40,
                                  label_alpha=LABEL_ALPHA)
    assert got.dtype == torch.bool and got.shape == want.shape == (8, 6, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_hq.numpy(), np.asarray(want_hq),
                               atol=1e-5)


@pytest.fixture
def shared_accmodel_init(monkeypatch):
    params = _np_tree(jam.accmodel_init(jax.random.PRNGKey(1), WIDTH))
    monkeypatch.setattr(jtr, "accmodel_init",
                        lambda key, width: _jnp_tree(params))
    monkeypatch.setattr(ttr, "accmodel_init",
                        lambda seed, width, device: accmodel_from_numpy(
                            params, device=device))


@pytest.mark.parametrize("trainer", ["train_accmodel", "train_accmodel_e2e"])
def test_trainer_matches_reference(trainer, nets, scene,
                                   shared_accmodel_init):
    """Two epochs of 2 batches from the same initial weights: the loss of
    each epoch, the final weights and the trained AccModel's scores on
    other frames."""
    want = getattr(jtr, trainer)(
        jv.FinalDNN("detection", _jnp_tree(nets["detection"])),
        scene.frames, epochs=2, width=WIDTH)
    td = final_dnn_from_numpy("detection", nets["detection"], device="cpu")
    got = getattr(ttr, trainer)(td, scene.frames, epochs=2, width=WIDTH)
    assert got.epochs == 2 and len(got.losses) == 2
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    flat_want = _flatten(_np_tree(want.accmodel.params))
    flat_got = accmodel_to_numpy(got.accmodel)
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_allclose(flat_got[k], flat_want[k],
                                   atol=WEIGHT_ATOL, err_msg=k)
    probe = make_scene("dashcam", seed=LABEL_SEED + 1, T=2, H=H, W=W).frames
    np.testing.assert_allclose(
        got.accmodel.scores(torch.from_numpy(probe)).numpy(),
        np.asarray(want.accmodel.scores(jnp.asarray(probe))),
        atol=SCORE_ATOL)
    assert got.accmodel.name == want.accmodel.name
    assert got.label_time_s > 0 and got.train_time_s > 0
    assert got.total_time_s == got.label_time_s + got.train_time_s
    assert all(p.grad is None for p in td.parameters())


def test_train_final_dnn_matches_reference(monkeypatch):
    """Five steps of the detector from the same initial weights, neither
    package's cache touched."""
    params = _np_tree(jv.init_net("detection", jax.random.PRNGKey(0), WIDTH))
    monkeypatch.setattr(jv, "init_net",
                        lambda task, key, width: _jnp_tree(params))
    monkeypatch.setattr(tv, "init_net",
                        lambda task, seed, width, device: final_dnn_from_numpy(
                            task, params, device=device))
    kw = dict(steps=5, H=H, W=W, width=WIDTH, cache=False)
    want = jvt.train_final_dnn("detection", "dashcam", **kw)
    got = tvt.train_final_dnn("detection", "dashcam", device="cpu", **kw)
    assert got.name == want.name == "detection_dashcam_w8_s5"
    flat_want, flat_got = _flatten(_np_tree(want.params)), final_dnn_to_numpy(got)
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_allclose(flat_got[k], flat_want[k],
                                   atol=WEIGHT_ATOL, err_msg=k)
    init = _flatten(params)
    assert sum(np.any(flat_got[k] != init[k]) for k in init) > 0.5 * len(init)


@pytest.mark.parametrize("task", TASKS)
def test_train_final_dnn_cache_roundtrip(task, tmp_path, monkeypatch):
    """With ``cache``, the port writes the reference's flat npz form into
    its own cache directory (never a temporary file left behind) and a
    second call loads the same weights without training."""
    assert tvt.CACHE.parts[-2:] == ("experiments", "models_torch")
    monkeypatch.setattr(tvt, "CACHE", tmp_path)
    kw = dict(steps=2, H=H, W=W, width=WIDTH, name=f"t_{task}",
              device="cpu")
    first = tvt.train_final_dnn(task, "surf", **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"t_{task}.npz"]
    with np.load(tmp_path / f"t_{task}.npz") as npz:
        saved = dict(npz)
    expected = final_dnn_to_numpy(first)
    assert set(saved) == set(expected)
    for k in expected:
        np.testing.assert_array_equal(saved[k], expected[k])
    monkeypatch.setattr(tv, "init_net", None)  # a load must not train
    second = tvt.train_final_dnn(task, "surf", **kw)
    for (k, a), (k2, b) in zip(first.state_dict().items(),
                               second.state_dict().items()):
        assert k == k2 and torch.equal(a, b)


@pytest.mark.parametrize("task", TASKS)
def test_weights_round_trip_is_bit_equal(task, nets):
    flat = _flatten(nets[task])
    net = final_dnn_from_numpy(task, flat, device="cpu")
    back = final_dnn_to_numpy(net)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], flat[k])
    am = _flatten(_np_tree(jam.accmodel_init(jax.random.PRNGKey(9), WIDTH)))
    back = accmodel_to_numpy(accmodel_from_numpy(am, device="cpu"))
    assert set(back) == set(am)
    for k in am:
        np.testing.assert_array_equal(back[k], am[k])
