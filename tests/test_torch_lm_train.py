"""The port's LM training against the reference, on the CPU.

One train step of each ported reduced configuration, in fp32 (B 2, S 16),
from the reference's ``init_train_state(PRNGKey(0))`` carried across with
``weights.train_state_from_numpy``; the reference's gradients come from
``jax.value_and_grad`` of its ``make_loss_fn`` and its update from
``AdamW.update`` on them. Bounds: loss, nll and the MoE loss within 1e-5
relative; the gradient norm within 1e-4 relative; every gradient leaf
within 1e-4 of its largest |g| (fp32 sums in other orders through a few
layers). The gradients are compared directly: AdamW's first step is
nearly sign(g) times the rate, so the updated parameters are held within
1e-6 only where |g| is at least 1e-3 of its leaf's largest (where the
sign cannot flip), and within twice the rate elsewhere.

This file holds the dense, RWKV and MoE configurations; the hybrid, VLM
and encoder-decoder ones are in ``tests/test_torch_lm_train_hybrid.py``,
which imports the helpers here. Also here: gradient accumulation, the NaN
guard, the three remat modes, the repaired ``wkv_chunked`` and the
``wkv6`` autograd Function's backward, and the training driver.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.distributed.sharding import local_rules
from repro.kernels.wkv6.ref import wkv6_ref as ref_wkv6_oracle
from repro.models.rwkv6 import wkv_chunked as ref_wkv_chunked
from repro.models.transformer import build_model
from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import _dequantize_blockwise as ref_dequantize
from repro.optim.adamw import warmup_cosine as ref_warmup_cosine
from repro.train import steps as ref_steps
from repro_torch.configs import get_reduced_config
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv_chunked
from repro_torch.launch import train as train_launch
from repro_torch.models import DecoderLM
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.train import steps
from repro_torch.weights import (_flat, _ref_flat, train_state_from_numpy,
                                 train_state_to_numpy)

ARCHS = ["smollm_360m", "rwkv6_1b6", "stablelm_3b", "olmoe_1b_7b",
         "moonshot_v1_16b_a3b"]
B, S = 2, 16
BASE_LR, WARMUP, TOTAL = 1e-3, 10, 100  # the rate at count 1 is 1e-4
LOSS_REL, NORM_REL, GRAD_REL = 1e-5, 1e-4, 1e-4
RULES = local_rules()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(cfg, seed, batch=B, seq=S):
    """tokens and next-token labels (and a VLM's context or an
    encoder-decoder's frames, N(0, 0.3)) drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(
        np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.cross_attn_every:
        out["context"] = (0.3 * rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = (0.3 * rng.standard_normal(
            (batch, seq, cfg.d_model))).astype(np.float32)
    return out


def train_case(arch):
    """Both packages' first train step on the same state and batch ->
    dict of numpy results, the reference's and the port's."""
    cfg = ref_reduced_config(arch)
    ref = build_model(cfg, RULES, compute_dtype=jnp.float32,
                      param_dtype=jnp.float32)
    ref_opt = RefAdamW(schedule=ref_warmup_cosine(BASE_LR, WARMUP, TOTAL))
    state = ref_steps.init_train_state(ref, ref_opt, jax.random.PRNGKey(0))
    batch = make_batch(cfg, seed=7)
    loss_fn = ref_steps.make_loss_fn(ref, cfg, RULES)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state["params"],
                                {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    new_params, _, opt_metrics = ref_opt.update(grads, state["opt"],
                                                state["params"])
    np_state = jax.tree_util.tree_map(np.asarray, state)

    pcfg = get_reduced_config(arch)
    model, pstate = train_state_from_numpy(pcfg, np_state, device="cpu")
    back = train_state_to_numpy(model, pstate)
    opt = AdamW(schedule=warmup_cosine(BASE_LR, WARMUP, TOTAL))
    p_loss, p_metrics, p_grads = steps.make_grad_fn(model, pcfg)(
        pstate["params"], {k: torch.from_numpy(v) for k, v in
                           batch.items()})
    pstate, p_step = steps.make_train_step(model, pcfg, opt)(pstate, batch)
    return {
        "ref": {"loss": float(loss), "nll": float(metrics["nll"]),
                "aux": float(metrics["aux"]),
                "tokens": float(metrics["tokens"]),
                "grad_norm": float(opt_metrics["grad_norm"]),
                "lr": float(opt_metrics["lr"]),
                "grads": _flat(jax.tree_util.tree_map(np.asarray, grads)),
                "params": _flat(jax.tree_util.tree_map(np.asarray,
                                                       new_params)),
                "state": np_state},
        "port": {"grad_fn_loss": float(p_loss),
                 "metrics": {k: float(v) for k, v in p_step.items()},
                 "grad_fn_metrics": {k: float(v) for k, v in
                                     p_metrics.items()},
                 "grads": _ref_flat(pcfg, {n: g.numpy() for n, g in
                                           p_grads.items()}),
                 "after": train_state_to_numpy(model, pstate),
                 "round_trip": back},
    }


def check_step(case):
    ref, port = case["ref"], case["port"]
    m = port["metrics"]
    for k in ("loss", "nll", "aux"):
        assert m[k] == pytest.approx(ref[k], rel=LOSS_REL, abs=1e-30), k
        assert port["grad_fn_metrics"].get(k, port["grad_fn_loss"]) == \
            pytest.approx(ref[k], rel=LOSS_REL, abs=1e-30), k
    assert m["tokens"] == ref["tokens"] == B * S
    assert m["grad_norm"] == pytest.approx(ref["grad_norm"], rel=NORM_REL)
    assert m["lr"] == pytest.approx(ref["lr"], rel=1e-6)
    assert m["skipped"] == 0.0
    assert int(port["after"]["step"]) == 1
    assert int(port["after"]["opt"]["count"]) == 1


def check_gradients(case):
    ref, got = case["ref"]["grads"], case["port"]["grads"]
    assert set(got) == set(ref)
    for k, want in ref.items():
        assert got[k].shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got[k] - want).max())
        assert err <= GRAD_REL * scale, (k, err, scale)


def check_updated_params(case):
    lr = case["ref"]["lr"]
    want, got = case["ref"]["params"], case["port"]["after"]["params"]
    for k, w in want.items():
        g = case["ref"]["grads"][k]
        firm = np.abs(g) >= 1e-3 * np.abs(g).max()
        err = np.abs(got[k] - w)
        assert float(err[firm].max(initial=0.0)) <= 1e-6, k
        assert float(err.max()) <= 2 * lr + 1e-6, k


def check_round_trip(case):
    """The reference's initial state, carried to the port and back: the
    same values, leaf for leaf."""
    want, got = case["ref"]["state"], case["port"]["round_trip"]
    np.testing.assert_array_equal(got["step"], want["step"])
    np.testing.assert_array_equal(got["opt"]["count"],
                                  want["opt"]["count"])
    for part, w, g in (("params", want["params"], got["params"]),
                       ("m", want["opt"]["m"], got["opt"]["m"]),
                       ("v", want["opt"]["v"], got["opt"]["v"])):
        w = _flat(w)
        assert set(g) == set(w), part
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return train_case(request.param)


def test_train_step_matches_reference(case):
    check_step(case)


def test_gradients_match_reference(case):
    check_gradients(case)


def test_updated_parameters_match_reference(case):
    check_updated_params(case)


def test_train_state_round_trip(case):
    check_round_trip(case)


def _port_lm(arch, **replace):
    cfg = dataclasses.replace(get_reduced_config(arch), **replace)
    return cfg, DecoderLM(cfg, torch.float32, torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0))


def test_int8_second_moment_crosses_packages():
    """An int8 ``v`` from the reference's AdamW after one update, carried
    to the port: each block's values within half a quantization step of
    the stacked tensor's (requantized per block), the moment at zero (the
    initial state) bit for bit, and back within the same bound."""
    cfg = ref_reduced_config("smollm_360m")
    ref = build_model(cfg, RULES, compute_dtype=jnp.float32,
                      param_dtype=jnp.float32)
    opt = RefAdamW(schedule=ref_warmup_cosine(BASE_LR, WARMUP, TOTAL),
                   quantized_v=True)
    state = ref_steps.init_train_state(ref, opt, jax.random.PRNGKey(0))
    zero = jax.tree_util.tree_map(np.asarray, state)
    _, z = train_state_from_numpy(get_reduced_config("smollm_360m"), zero,
                                  device="cpu")
    assert all(int(x["q"].abs().max()) == 0 for x in z["opt"]["v"].values())
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.random.default_rng(p.size).standard_normal(
            p.shape), jnp.float32), state["params"])
    _, new_opt, _ = opt.update(grads, state["opt"], state["params"])
    state = jax.tree_util.tree_map(np.asarray, dict(state, opt=new_opt))
    model, pstate = train_state_from_numpy(
        get_reduced_config("smollm_360m"), state, device="cpu")
    back = train_state_to_numpy(model, pstate)["opt"]["v"]
    shapes = {k: v.shape for k, v in _flat(state["params"]).items()}
    for key, qs in _flat_q(state["opt"]["v"]).items():
        want = np.asarray(ref_dequantize(qs["q"], qs["scale"], shapes[key]))
        step = float(np.abs(want).max()) / 127.0
        got = np.asarray(ref_dequantize(back[key]["q"], back[key]["scale"],
                                 shapes[key]))
        assert float(np.abs(got - want).max()) <= step, key


def _flat_q(tree, prefix=""):
    if set(tree) == {"q", "scale"}:
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_q(v, f"{prefix}/{k}" if prefix else k))
    return out


def test_grad_accum_matches_single_batch():
    """grad_accum 2 gives the gradients and the update of one batch of
    the same 4 rows (exact in fp32 but for the order of two sums), as the
    reference's own test."""
    cfg, _ = _port_lm("smollm_360m")
    batch = make_batch(cfg, seed=3, batch=4)
    out = {}
    for accum in (1, 2):
        _, model = _port_lm("smollm_360m")
        opt = AdamW(schedule=warmup_cosine(BASE_LR, WARMUP, TOTAL))
        state = steps.init_train_state(model, opt, "cpu")
        _, _, grads = steps.make_grad_fn(model, cfg, accum)(
            state["params"], {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        state, metrics = steps.make_train_step(model, cfg, opt, accum)(
            state, batch)
        out[accum] = grads, metrics, state
    (g1, m1, s1), (g2, m2, s2) = out[1], out[2]
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for n in g1:
        scale = float(g1[n].abs().max())
        assert float((g1[n] - g2[n]).abs().max()) <= 1e-5 * scale, n
        np.testing.assert_allclose(s2["params"][n].detach().numpy(),
                                   s1["params"][n].detach().numpy(),
                                   atol=1e-5)


def test_nan_guard_keeps_parameters_and_moments():
    """A step whose loss is not finite (an inf in the final norm's scale)
    changes no parameter, moment or count, says ``skipped`` 1 and counts
    the step; the next finite step moves them again."""
    cfg, model = _port_lm("smollm_360m")
    opt = AdamW(schedule=warmup_cosine(BASE_LR, 0, TOTAL))
    state = steps.init_train_state(model, opt, "cpu")
    step = steps.make_train_step(model, cfg, opt)
    state, _ = step(state, make_batch(cfg, seed=1))
    with torch.no_grad():
        model.final_norm.scale[0] = float("inf")
    before = [t.detach().clone() for t in jax.tree_util.tree_leaves(
        {"p": state["params"], "o": state["opt"]})]
    state, metrics = step(state, make_batch(cfg, seed=2))
    assert not np.isfinite(float(metrics["loss"]))
    assert float(metrics["skipped"]) == 1.0 and int(state["step"]) == 2
    after = jax.tree_util.tree_leaves({"p": state["params"],
                                       "o": state["opt"]})
    for a, b in zip(after, before):
        assert torch.equal(a.detach(), b)
    with torch.no_grad():
        model.final_norm.scale[0] = 1.0
    w = model.embed.emb.detach().clone()
    state, metrics = step(state, make_batch(cfg, seed=2))
    assert float(metrics["skipped"]) == 0.0
    assert int(state["opt"]["count"]) == 2
    assert not torch.equal(model.embed.emb.detach(), w)


@pytest.mark.parametrize("arch", ["smollm_360m", "rwkv6_1b6",
                                  "jamba1_5_large_398b"])
def test_remat_modes_give_the_same_gradients(arch):
    """none, full and dots: the same gradients (the recompute repeats the
    forward's arithmetic), through attention, RWKV and Mamba's
    checkpointed chunks with MoE."""
    got = {}
    for remat in ("none", "full", "dots"):
        cfg, model = _port_lm(arch, remat=remat)
        for p in model.parameters():
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(cfg, seed=4, seq=32).items()}
        params = dict(model.named_parameters())
        got[remat] = steps.make_grad_fn(model, cfg)(params, batch)[2]
    for remat in ("full", "dots"):
        for n, g in got["none"].items():
            scale = float(g.abs().max())
            assert float((got[remat][n] - g).abs().max()) <= \
                1e-6 * scale, (remat, n)


def _wkv_case(log_decay, seed=0, B_=1, S_=64, H=2, hd=16):
    """r, k, v (x0.5), the log-decay (a constant, or -exp(N(-1, 0.5)) for
    None), u (x0.3), s0 (x0.2), and cotangents of o and the state."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    r, k, v = (n(B_, S_, H, hd, scale=0.5) for _ in range(3))
    ld = (np.full((B_, S_, H, hd), log_decay, np.float32)
          if log_decay is not None
          else -np.exp(n(B_, S_, H, hd, scale=0.5) - 1.0))
    return ((r, k, v, ld, n(H, hd, scale=0.3), n(B_, H, hd, hd, scale=0.2)),
            (n(B_, S_, H, hd), n(B_, H, hd, hd)))


def _torch_grads(fn, xs, cots):
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    outs = fn(*ts)
    return torch.autograd.grad(outs, ts, [torch.from_numpy(c)
                                          for c in cots])


def _jax_grads(fn, xs, cots):
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in xs))
    return vjp(tuple(jnp.asarray(c) for c in cots))


@pytest.mark.parametrize("log_decay", [-0.5, None])
def test_wkv_chunked_gradients_match_reference(log_decay):
    """Where the reference's chunked form has finite gradients (slow
    decays), the repaired one gives the same: within 1e-5 of each
    gradient's largest entry."""
    xs, cots = _wkv_case(log_decay)
    got = _torch_grads(wkv_chunked, xs, cots)
    want = _jax_grads(ref_wkv_chunked, xs, cots)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        assert float(np.abs(g.numpy() - w).max()) <= \
            1e-5 * float(np.abs(w).max())


def test_wkv_chunked_gradients_finite_for_fast_decays():
    """At log-decay -3 the reference's chunked form overflows exp(Lx[t] -
    L[s]) at s >= t and its gradients hold NaN (its fault, kept); the
    port's masks the exponent first: finite gradients, equal to autograd
    of the token-by-token oracle within 1e-4 of each one's largest."""
    xs, cots = _wkv_case(-3.0)
    want = [np.asarray(w) for w in _jax_grads(ref_wkv_chunked, xs, cots)]
    assert any(np.isnan(w).any() for w in want)
    got = _torch_grads(wkv_chunked, xs, cots)
    oracle = _torch_grads(wkv6_ref, xs, cots)
    oracle_jax = _jax_grads(ref_wkv6_oracle, xs, cots)
    for g, o, oj in zip(got, oracle, oracle_jax):
        assert torch.isfinite(g).all()
        scale = float(o.abs().max())
        assert float((g - o).abs().max()) <= 1e-4 * scale
        np.testing.assert_allclose(o.numpy(), np.asarray(oj),
                                   atol=1e-5 * scale)


def test_wkv6_function_backward_is_the_chunked_forms(monkeypatch):
    """``WKV6Function`` with the kernel's launch stood in by a plain call
    (no CUDA here): its forward is that call, its backward the gradients
    of ``wkv_chunked`` in fp32, each cast to its input's type (bf16 r, k
    and v), one backward counted a call; an input that needs no gradient
    gets None."""
    monkeypatch.setattr(wkv_ops, "wkv6_cuda", lambda *xs: wkv_chunked(*xs))
    xs, cots = _wkv_case(None, seed=5)
    ts = [torch.from_numpy(x.copy()) for x in xs]
    bf = [t.to(torch.bfloat16) for t in ts[:3]] + ts[3:]
    ins = [t.clone().requires_grad_(i != 5) for i, t in enumerate(bf)]
    before = wkv_ops.BACKWARDS["wkv6"]
    outs = wkv_ops.WKV6Function.apply(*ins)
    got = torch.autograd.grad(outs, ins[:5], [torch.from_numpy(c)
                                              for c in cots])
    assert wkv_ops.BACKWARDS["wkv6"] == before + 1
    ref_ins = [t.clone().requires_grad_(i != 5) for i, t in enumerate(bf)]
    want = torch.autograd.grad(wkv_chunked(*ref_ins), ref_ins[:5],
                               [torch.from_numpy(c) for c in cots])
    for g, w, x in zip(got, want, ins):
        assert g.dtype == x.dtype
        assert torch.equal(g, w)


def test_train_driver_runs_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU: 6 steps with a checkpoint every
    2, then a resume that goes on to step 8 from the newest checkpoint."""
    args = ["--arch", "smollm_360m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    assert train_launch.main(args + ["--steps", "6"]) == 0
    first = capsys.readouterr().out
    assert "step 5: loss=" in first and "[done] step 6" in first
    assert "[resume]" not in first
    assert train_launch.main(args + ["--steps", "8"]) == 0
    second = capsys.readouterr().out
    assert f"[resume] restored step 6 from {tmp_path}" in second
    assert "step 6: loss=" in second and "[done] step 8" in second
    assert "step 5: loss=" not in second
