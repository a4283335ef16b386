"""The port's MoE layer (the dense path) and olmoe-1b-7b against the
reference, on the CPU.

``repro_torch.models.moe.MoE`` meets ``repro.models.moe.MoE(...,
impl="dense")`` under ``local_rules()`` at olmoe-reduced's (d 128, f 64,
8 experts, top-2) and moonshot-reduced's (f 96, top-3) sizes, fp32, with
the reference's weights from ``init(PRNGKey(0))`` carried across by numpy
and inputs from numpy seeds, at capacity factors 1.25 (the default), 8.0
(dropless) and 0.25 (drops), for a decode-sized call (T = 2) and T = 64.
Bounds: out atol 1e-5, rtol 1e-4 (fp32 products summed in other orders);
aux and the drop fraction within 1e-6. One torch thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.distributed.sharding import local_rules
from repro.models import moe as RM
from repro.models.transformer import build_model
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import serve
from repro_torch.models import DecoderLM
from repro_torch.models.moe import MoE, moe_exact_reference, top_k
from repro_torch.weights import lm_from_numpy, lm_to_numpy

OUT_TOL = dict(atol=1e-5, rtol=1e-4)
AUX_TOL = 1e-6
# (d, f, experts, top-k): olmoe-reduced's and moonshot-reduced's MoE
SIZES = {"olmoe": (128, 64, 8, 2), "moonshot": (128, 96, 8, 3)}
# moonshot-v1-16b-a3b's routing (64 experts, top-6) at a narrow width
MOONSHOT_ROUTING = (64, 48, 64, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the machine's cores.
    Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(size, cf, dtype=torch.float32):
    """(reference MoE, its params, the port's MoE on the same weights);
    ``size`` a key of SIZES or (d, f, experts, top-k)."""
    d, f, E, k = SIZES.get(size, size)
    ref = RM.MoE(d, f, E, k, cf, impl="dense")
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(0)))
    port = MoE(d, f, E, k, cf, dtype=dtype, device="cpu")
    with torch.no_grad():
        port.router.w.copy_(torch.from_numpy(params["router"]["w"].copy()))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(port, name).copy_(torch.from_numpy(params[name].copy()))
    return ref, params, port


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _both(ref, params, port, x):
    out, (aux, drop) = ref(params, jnp.asarray(x), local_rules())
    with torch.no_grad():
        got, (taux, tdrop) = port(torch.from_numpy(x))
    return (np.asarray(out), float(aux), float(drop)), (got, taux, tdrop)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("cf", [1.25, 8.0, 0.25])
@pytest.mark.parametrize("B,S", [(2, 1), (4, 16)])
def test_moe_matches_the_reference_dense_path(size, cf, B, S):
    ref, params, port = _pair(size, cf)
    x = _x(B, S, port.d_model, seed=B * S + int(4 * cf))
    (out, aux, drop), (got, taux, tdrop) = _both(ref, params, port, x)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert taux.dtype == tdrop.dtype == torch.float32
    assert taux.shape == tdrop.shape == ()
    np.testing.assert_allclose(got.numpy(), out, **OUT_TOL)
    assert abs(float(taux) - aux) <= AUX_TOL
    assert abs(float(tdrop) - drop) <= AUX_TOL
    assert port.capacity(B * S) == ref._capacity(B * S)
    if cf == 8.0:  # dropless: every token's own top-k experts
        assert float(tdrop) == 0.0
        np.testing.assert_allclose(
            moe_exact_reference(port, torch.from_numpy(x)).numpy(),
            got.numpy(), **OUT_TOL)
        np.testing.assert_allclose(
            moe_exact_reference(port, torch.from_numpy(x)).numpy(),
            np.asarray(RM.moe_exact_reference(params, jnp.asarray(x),
                                              port.top_k)), **OUT_TOL)
    if cf == 0.25 and B * S == 64:
        assert float(tdrop) > 0


@pytest.mark.parametrize("T", [1, 2, 16, 2048, 16384])
def test_capacity_follows_the_reference(T):
    """olmoe's C at decode (16 tokens: 3) and prefill (16 x 1024: 2560)."""
    for cf in (1.25, 8.0, 0.25):
        port = MoE(2048, 8, 64, 8, cf, device="cpu")
        ref = RM.MoE(2048, 8, 64, 8, cf)
        assert port.capacity(T) == ref._capacity(T)
    default = MoE(2048, 8, 64, 8, device="cpu")
    assert default.capacity(16) == 3 and default.capacity(16384) == 2560


def test_top_k_breaks_ties_toward_the_lower_index():
    """Equal values come out in ascending index order, as
    ``jax.lax.top_k``'s."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (64, 40)).astype(np.float32)  # many ties
    for k in (1, 3, 17, 40):
        values, indices = top_k(torch.from_numpy(x), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(indices.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_tied_gates_keep_the_reference_tokens(size):
    """A batch of one token repeated: every gate ties, each of its experts
    keeps C < T of them, the lowest token ids (as the reference's top-k
    over ``gates.T``); the others come out as zeros."""
    ref, params, port = _pair(size, 1.25)
    T = 24
    x = np.repeat(_x(1, 1, port.d_model, seed=3), T, axis=1)
    (out, aux, drop), (got, taux, tdrop) = _both(ref, params, port, x)
    C = port.capacity(T)
    assert C < T
    kept = np.flatnonzero(np.abs(got.numpy()[0]).max(-1) > 0)
    want = np.flatnonzero(np.abs(out[0]).max(-1) > 0)
    np.testing.assert_array_equal(kept, np.arange(C))
    np.testing.assert_array_equal(kept, want)
    np.testing.assert_allclose(got.numpy(), out, **OUT_TOL)
    assert abs(float(tdrop) - drop) <= AUX_TOL and float(tdrop) > 0


def test_moe_is_deterministic():
    """The combine gathers (no atomics): two calls give the same bits."""
    port = _pair("olmoe", 1.25)[2]
    x = torch.from_numpy(_x(8, 16, port.d_model, seed=5))
    with torch.no_grad():
        a, (aux_a, drop_a) = port(x)
        b, (aux_b, drop_b) = port(x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert torch.equal(drop_a, drop_b)


def test_router_stays_fp32_and_init_draws_the_reference_distributions():
    """The router is fp32 whatever the experts' type; the weights' spreads
    are the reference's N(0, 1/d) and N(0, 1/f) (the generators differ,
    so the values do)."""
    d, f, E, k = SIZES["olmoe"]
    port = MoE(d, f, E, k, dtype=torch.bfloat16, device="cpu")
    port.reset(torch.Generator().manual_seed(0))
    assert port.router.w.dtype == torch.float32
    assert all(getattr(port, n).dtype == torch.bfloat16
               for n in ("w_gate", "w_up", "w_down"))
    want = RM.MoE(d, f, E, k).init(jax.random.PRNGKey(0))
    for got, ref in ((port.router.w, want["router"]["w"]),
                     (port.w_gate, want["w_gate"]),
                     (port.w_up, want["w_up"]),
                     (port.w_down, want["w_down"])):
        g, w = got.float().numpy(), np.asarray(ref)
        assert g.shape == w.shape
        assert abs(g.std() / w.std() - 1) < 0.05
        assert abs(g.mean()) < 0.05 * w.std()


# ---------------------------------------------------------------------------
# olmoe-1b-7b
# ---------------------------------------------------------------------------
def test_olmoe_config_is_the_published_one():
    for mine, theirs in ((get_config("olmoe-1b-7b"),
                          ref_config("olmoe_1b_7b")),
                         (get_reduced_config("olmoe_1b_7b"),
                          ref_reduced_config("olmoe_1b_7b"))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config("olmoe-1b-7b")
    assert (full.hd, full.n_kv_heads, full.n_experts, full.top_k,
            full.kv_cache_dtype) == (128, 16, 64, 8, "bfloat16")


def _ref_params(cfg_name="olmoe_1b_7b", seed=0):
    ref = build_model(ref_reduced_config(cfg_name), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray,
                                  ref.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_olmoe_weights_round_trip_with_the_router_in_fp32(dtype):
    """``lm_from_numpy`` loads the reference's MoE tree key for key
    (``blocks/sub0/ffn/{router/w, w_gate, w_up, w_down}``), the router
    fp32 under a bf16 ``dtype``; ``lm_to_numpy`` gives it back (exactly in
    fp32; the bf16 experts as their rounding)."""
    _check_weights_round_trip("olmoe_1b_7b", dtype)


def _check_weights_round_trip(arch, dtype):
    cfg = get_reduced_config(arch)
    params = _ref_params(arch)
    model = lm_from_numpy(cfg, params, device="cpu", dtype=dtype)
    ffn = model.stack.blocks[0]["sub0"].ffn
    assert isinstance(ffn, MoE) and ffn.router.w.dtype == torch.float32
    assert ffn.w_gate.dtype == dtype
    flat = lm_to_numpy(model)
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)}
    assert sorted(flat) == sorted(want)
    for name in ("router/w", "w_gate", "w_up", "w_down"):
        assert f"blocks/sub0/ffn/{name}" in flat
    for key, v in want.items():
        if dtype == torch.float32 or "router" in key or "norm" in key:
            np.testing.assert_array_equal(flat[key], v, err_msg=key)
        else:
            np.testing.assert_array_equal(
                flat[key], torch.from_numpy(v.copy()).to(dtype).float().numpy(),
                err_msg=key)


def test_olmoe_bf16_serving_runs_and_routes_on_the_cpu():
    """olmoe-reduced in bf16 (weights and compute, the router fp32): the
    serving loop gives finite logits and tokens; ``hidden``'s aux is the
    sum of its MoE sublayers' (fp32, positive)."""
    cfg = get_reduced_config("olmoe-1b-7b")
    model = DecoderLM(cfg, torch.bfloat16, torch.bfloat16, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32))
    res = serve.serve_tokens(model, prompts, 5)
    assert res.finite and res.tokens.shape == (4, 5)
    h, aux, _ = model.hidden(prompts.long())
    assert h.dtype == torch.bfloat16 and aux.dtype == torch.float32
    x, total = model.embed(prompts.long(), torch.bfloat16), 0.0
    for block in model.stack.blocks:
        sub = block["sub0"]
        x = x + sub.mixer(sub.norm1(x))[0]
        o, (a, _) = sub.ffn(sub.norm2(x))
        x, total = x + o, total + float(a)
    assert float(aux) == pytest.approx(total, rel=1e-6) and total > 0


def test_main_serves_olmoe_on_the_cpu(capsys):
    _check_main_serves("olmoe-1b-7b", capsys)


def _check_main_serves(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "5", "--gen", "4"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    for what in (f"[serve] {arch}", "prefill:", "decode: p50=",
                 "sample:", "eager"):
        assert what in out


# ---------------------------------------------------------------------------
# moonshot-v1-16b-a3b
# ---------------------------------------------------------------------------
def test_moonshot_config_is_the_published_one():
    for mine, theirs in ((get_config("moonshot-v1-16b-a3b"),
                          ref_config("moonshot_v1_16b_a3b")),
                         (get_reduced_config("moonshot_v1_16b_a3b"),
                          ref_reduced_config("moonshot_v1_16b_a3b"))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config("moonshot-v1-16b-a3b")
    assert (full.n_layers, full.d_model, full.hd, full.n_kv_heads,
            full.d_ff, full.n_experts, full.top_k, full.vocab_size,
            full.rope_theta, full.kv_cache_dtype) == (
        48, 2048, 128, 16, 1408, 64, 6, 163_840, 50_000.0, "int8")


@pytest.mark.parametrize("T,C", [(16, 3), (16384, 1920)])
def test_moonshot_capacity_at_top_6(T, C):
    """moonshot's C at decode (16 tokens: 3) and prefill (16 x 1024:
    1920), as the reference's at top-6 of 64 experts."""
    port = MoE(2048, 8, 64, 6, device="cpu")
    assert port.capacity(T) == RM.MoE(2048, 8, 64, 6)._capacity(T) == C


@pytest.mark.parametrize("B,S", [(16, 1), (4, 16)])
def test_moonshot_routing_matches_the_reference(B, S):
    """moonshot's routing, 64 experts at top-6 (d 64, f 48), for a decode
    step at batch 16 (C = 3) and 64 tokens: out within 1e-5, the drop
    fraction within 1e-6 and aux within 1e-6 of its value (E = 64 makes
    aux ~10, where one ulp is 1e-6), as the reference's dense path."""
    ref, params, port = _pair(MOONSHOT_ROUTING, 1.25)
    x = _x(B, S, port.d_model, seed=27 + B)
    (out, aux, drop), (got, taux, tdrop) = _both(ref, params, port, x)
    assert port.capacity(B * S) == ref._capacity(B * S)
    np.testing.assert_allclose(got.numpy(), out, **OUT_TOL)
    assert abs(float(taux) - aux) <= AUX_TOL * abs(aux)
    assert abs(float(tdrop) - drop) <= AUX_TOL and float(tdrop) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moonshot_weights_round_trip_with_the_router_in_fp32(dtype):
    _check_weights_round_trip("moonshot_v1_16b_a3b", dtype)


def test_main_serves_moonshot_on_the_cpu(capsys):
    _check_main_serves("moonshot-v1-16b-a3b", capsys)
