"""The port's AdamW, chunked cross-entropy and token pipeline against the
reference, on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
Bounds: AdamW's parameters and fp32 moments within 1e-6 absolute of the
reference's after each step (the same fp32 arithmetic; XLA's ``pow`` and
``sqrt`` may differ by an ulp); bf16 moments within one bf16 ulp of
theirs; the int8 second moment's ``q`` equal but at round-half ties (the
division can land on .5 in one package and a neighbour in the other), off
by one there, its scales within 1e-6 relative. The rate of
``warmup_cosine`` within 1e-9 absolute (fp32 arithmetic on rates of at
most 1e-3). The cross-entropy's value within 1e-6 relative and its
gradient within 1e-6 absolute of the reference's (fp32 sums in other
orders). ``batch_at`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import DataConfig as RefDataConfig
from repro.data.tokens import batch_at as ref_batch_at
from repro.distributed.sharding import local_rules
from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import _quantize_blockwise as ref_quantize
from repro.optim.adamw import warmup_cosine as ref_warmup_cosine
from repro.train.loss import chunked_softmax_xent as ref_xent
from repro_torch.data.tokens import DataConfig, PrefetchingLoader, batch_at
from repro_torch.optim.adamw import (QBLOCK, AdamW, _dequantize_blockwise,
                                     _quantize_blockwise, tree_global_norm,
                                     warmup_cosine)
from repro_torch.train.loss import chunked_softmax_xent

RULES = local_rules()
# a matrix, a vector, a 3-D tensor whose size is no multiple of QBLOCK
SHAPES = {"w": (24, 40), "b": (40,), "t": (3, 5, 70)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other test files of the port (the
    suite's workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(moment_dtype, quantized, clip_norm, steps=3):
    """``steps`` updates of both optimizers from the same parameters with
    the same gradients -> (reference states, port states), one per step,
    as numpy."""
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              clip_norm=clip_norm, quantized_v=quantized)
    ref = RefAdamW(schedule=ref_warmup_cosine(1e-3, 2, 10),
                   moment_dtype=jnp.dtype(moment_dtype), **kw)
    port = AdamW(schedule=warmup_cosine(1e-3, 2, 10),
                 moment_dtype=getattr(torch, moment_dtype), **kw)
    p0 = _draws(0)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = ref.init(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = port.init(tp)
    out = []
    for i in range(steps):
        g = _draws(10 + i, scale=3.0)
        rp, rs, rm = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                rs, rp)
        _, ts, tm = port.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp)
        out.append(((jax.tree_util.tree_map(np.asarray, rp),
                     jax.tree_util.tree_map(np.asarray, rs), rm),
                    ({k: v.clone() for k, v in tp.items()},
                     jax.tree_util.tree_map(lambda t: t.clone(), ts), tm)))
    return out


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1e9, 1.0])
def test_adamw_matches_reference(moment_dtype, clip_norm):
    """Parameters, moments, count, rate and gradient norm after each of
    three steps; clip_norm 1.0 clips (the gradients' norm is ~50)."""
    for (rp, rs, rm), (tp, ts, tm) in _run_both(moment_dtype, False,
                                                clip_norm):
        assert int(ts["count"]) == int(rs["count"])
        assert abs(float(tm["lr"]) - float(rm["lr"])) <= 1e-9
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        if clip_norm < 1e9:
            assert float(tm["grad_norm"]) > 10 * clip_norm
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), rp[k], atol=1e-6)
            for mom in ("m", "v"):
                got, want = ts[mom][k], rs[mom][k]
                assert str(got.dtype).endswith(moment_dtype)
                if moment_dtype == "float32":
                    np.testing.assert_allclose(_f32(got), _f32(want),
                                               atol=1e-6)
                else:  # one bf16 ulp of the value
                    np.testing.assert_allclose(
                        _f32(got), _f32(want),
                        atol=1e-30, rtol=2.0 ** -7)


def test_adamw_int8_second_moment_matches_reference():
    for (rp, rs, rm), (tp, ts, tm) in _run_both("float32", True, 1.0):
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), rp[k], atol=1e-6)
            q, want_q = ts["v"][k]["q"].numpy(), np.asarray(rs["v"][k]["q"])
            assert q.dtype == np.int8 and q.shape == want_q.shape
            off = np.abs(q.astype(int) - want_q.astype(int))
            assert off.max() <= 1 and (off > 0).mean() < 1e-2
            np.testing.assert_allclose(ts["v"][k]["scale"].numpy(),
                                       np.asarray(rs["v"][k]["scale"]),
                                       rtol=1e-6)


def test_adamw_decays_matrices_only():
    opt = AdamW(schedule=lambda t: torch.tensor(0.1), weight_decay=0.5,
                clip_norm=1e9)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    state = opt.init(params)
    opt.update({k: torch.zeros_like(v) for k, v in params.items()}, state,
               params)
    assert float((params["w"] - 1.0).abs().max()) > 1e-3  # decayed
    np.testing.assert_allclose(params["b"].numpy(), 1.0)  # not decayed


def test_adamw_clip_norm_reports_the_unclipped_norm():
    opt = AdamW(schedule=lambda t: torch.tensor(0.0), clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    _, _, metrics = opt.update({"w": torch.full((4,), 100.0)},
                               opt.init(params), params)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(tree_global_norm([torch.full((4,), 100.0),
                                   torch.full((3,), 0.0)])) == 200.0


def test_adamw_guard_keeps_everything_on_a_non_finite_loss():
    """With ``loss`` given, a non-finite loss or gradient norm leaves the
    parameters, both moments and the count as they were; a finite one
    moves them, and ``skipped`` says which."""
    opt = AdamW(schedule=warmup_cosine(1e-2, 0, 10))
    params = {k: torch.from_numpy(v) for k, v in _draws(1).items()}
    state = opt.init(params)
    g = {k: torch.from_numpy(v) for k, v in _draws(2).items()}
    before = jax.tree_util.tree_map(lambda t: t.clone(),
                                    {"p": params, "s": state})
    for bad_loss, bad_grad in ((float("nan"), False), (float("inf"), False),
                               (1.0, True)):
        grads = dict(g, b=torch.full_like(g["b"], float("nan"))) \
            if bad_grad else g
        _, _, m = opt.update(grads, state, params,
                             loss=torch.tensor(bad_loss))
        assert float(m["skipped"]) == 1.0
        for a, b in zip(jax.tree_util.tree_leaves({"p": params, "s": state}),
                        jax.tree_util.tree_leaves(before)):
            assert torch.equal(a, b)
    _, _, m = opt.update(g, state, params, loss=torch.tensor(1.0))
    assert float(m["skipped"]) == 0.0 and int(state["count"]) == 1
    assert not torch.equal(params["w"], before["p"]["w"])


def test_warmup_cosine_matches_reference():
    ref, port = (ref_warmup_cosine(1e-3, 20, 100),
                 warmup_cosine(1e-3, 20, 100))
    for step in list(range(0, 121, 3)) + [20, 100]:
        assert abs(float(port(torch.tensor(step, dtype=torch.int32)))
                   - float(ref(step))) <= 1e-9
    s = warmup_cosine(1.0, warmup=10, total=100, floor=0.1)
    assert float(s(0)) == 0.0
    assert float(s(10)) == pytest.approx(1.0, rel=1e-3)
    assert float(s(100)) == pytest.approx(0.1, rel=1e-2)


@pytest.mark.parametrize("seed,scale", [(1, 0.01), (2, 1.0), (3, 100.0)])
def test_quantize_blockwise_matches_reference(seed, scale):
    x = (scale * np.random.default_rng(seed).standard_normal(1000)).astype(
        np.float32)
    q, s = _quantize_blockwise(torch.from_numpy(x))
    rq, rs = ref_quantize(jnp.asarray(x))
    assert q.shape == (4, QBLOCK) and s.shape == (4, 1)
    off = np.abs(q.numpy().astype(int) - np.asarray(rq).astype(int))
    assert off.max() <= 1 and (off > 0).sum() <= 2
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    back = _dequantize_blockwise(q, s, x.shape).numpy()
    assert np.abs(back - x).max() <= np.abs(x).max() / 127.0 * 1.01


def _xent_inputs(seed, B, S, d, V, real):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (0.2 * rng.standard_normal((d, V))).astype(np.float32)
    labels = rng.integers(0, real, (B, S)).astype(np.int32)
    return h, w, labels


@pytest.mark.parametrize("chunk", [8, 5, 256])
def test_chunked_xent_matches_reference(chunk):
    """Value and gradient (w.r.t. h and the unembedding) against the
    reference; chunk 5 does not divide S = 32, so both take 4."""
    h, w, labels = _xent_inputs(0, 2, 32, 16, 64, 50)
    mask = (np.random.default_rng(9).random((2, 32)) > 0.2).astype(
        np.float32)

    def ref_loss(h, w):
        return ref_xent(h, w, jnp.asarray(labels), RULES, real_vocab=50,
                        chunk=chunk, mask=jnp.asarray(mask))

    jh, jw = jnp.asarray(h), jnp.asarray(w)
    want, want_n = ref_loss(jh, jw)
    gh, gw = jax.grad(lambda a, b: ref_loss(a, b)[0], argnums=(0, 1))(jh, jw)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got, n = chunked_softmax_xent(th, tw, torch.from_numpy(labels),
                                  real_vocab=50, chunk=chunk,
                                  mask=torch.from_numpy(mask))
    got.backward()
    assert float(n) == float(want_n) == mask.sum()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), atol=1e-6)


def test_chunked_xent_matches_dense():
    h, w, labels = _xent_inputs(1, 2, 16, 8, 32, 32)
    th = torch.from_numpy(h).requires_grad_()
    got, count = chunked_softmax_xent(th, torch.from_numpy(w),
                                      torch.from_numpy(labels),
                                      real_vocab=32, chunk=4)
    (gh,) = torch.autograd.grad(got, th)
    dh = torch.from_numpy(h).requires_grad_()
    dense = torch.nn.functional.cross_entropy(
        (dh @ torch.from_numpy(w)).reshape(-1, 32),
        torch.from_numpy(labels).long().reshape(-1))
    (want_g,) = torch.autograd.grad(dense, dh)
    assert float(count) == 32
    assert float(got.detach()) == pytest.approx(float(dense), rel=1e-6)
    np.testing.assert_allclose(gh.numpy(), want_g.numpy(), atol=1e-6)


def test_padded_vocab_never_predicted():
    """Masking the padded columns gives the loss of slicing them off, and
    their gradient is zero."""
    rng = np.random.default_rng(2)
    h = torch.from_numpy(5 * rng.standard_normal((1, 8, 4)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16)).astype(
        np.float32)).requires_grad_()
    labels = torch.zeros((1, 8), dtype=torch.int32)
    nll, _ = chunked_softmax_xent(h, w, labels, real_vocab=10)
    (gw,) = torch.autograd.grad(nll, w)
    nll2, _ = chunked_softmax_xent(h, w[:, :10], labels, real_vocab=10)
    assert float(nll) == pytest.approx(float(nll2), rel=1e-6)
    assert float(gw[:, 10:].abs().max()) == 0.0


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (0, 5, 0, 1), (3, 7, 1, 4), (11, 2, 3, 4), (5, 0, 0, 2)])
def test_batch_at_matches_reference(seed, step, shard, n_shards):
    cfg = dict(vocab_size=97, seq_len=48, global_batch=8, seed=seed)
    got = batch_at(DataConfig(**cfg), step, shard, n_shards)
    want = ref_batch_at(RefDataConfig(**cfg), step, shard, n_shards)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


def test_prefetching_loader_matches_batch_at():
    cfg = DataConfig(vocab_size=50, seq_len=16, global_batch=4)
    loader = PrefetchingLoader(cfg, start_step=10)
    try:
        for want_step in range(10, 14):
            step, batch = next(loader)
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          batch_at(cfg, step)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()
