"""The port's Mamba mixer and jamba-1.5-large-398b against the reference,
on the CPU.

The selective scan on inputs from numpy seeds (B 2, d_inner 16, N 4) at
chunks 8, 32 and 64, at S = 1 and at lengths no chunk divides; the Mamba
mixer (d 32, N 8) with the reference's ``init(PRNGKey)`` weights carried
across by name; jamba-reduced (one 8-sublayer block: 7 Mamba, 1
attention, 4 MLP, 4 MoE; d 128) and its five-sublayer prefix, the cut the
full config is served at, with the reference's weights through
``lm_from_numpy``; one torch thread. ``tests/test_torch_lm.py`` runs its
LM tests on jamba-reduced too. Bounds: the scan's outputs and states
atol 1e-5, rtol 1e-5 (fp32, one multiply-add a position against the
reference's associative scan); the mixer's outputs and states atol 1e-5,
rtol 1e-4 (fp32 products in other orders); logits within 1e-4 of the
reference's largest |logit|; decode against the port's own forward within
the reference's 2e-3 (``tests/test_models.py``), MoE at the dropless
capacity factor 8.0; greedy tokens identical on seeds whose top-two
logits stay more than 1e-3 apart.
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
from repro.models import mamba as RM
from repro.models.transformer import build_model
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE
from repro_torch.launch import serve
from repro_torch.models import DecoderLM
from repro_torch.models.mamba import Mamba, selective_scan_chunked
from repro_torch.weights import lm_from_numpy

ARCH = "jamba1_5_large_398b"
B, S, S1 = 2, 8, 4
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-5, rtol=1e-4)
LOGIT_REL, DECODE_REL, MARGIN = 1e-4, 2e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _prefix(cfg, k=5):
    """The first ``k`` sublayers of the block pattern, one block."""
    return dataclasses.replace(cfg, n_layers=k,
                               block_pattern=cfg.block_pattern[:k])


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------
def test_config_is_the_published_one():
    for mine, theirs in ((get_config("jamba-1.5-large-398b"),
                          ref_config(ARCH)),
                         (get_reduced_config(ARCH),
                          ref_reduced_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config(ARCH)
    assert (full.d_model, full.hd, full.n_heads // full.n_kv_heads,
            full.n_blocks, full.rope_theta, full.kv_cache_dtype) == (
                8192, 128, 8, 9, 0.0, "bfloat16")
    cut = _prefix(full)
    assert cut.n_blocks == 1 and cut.block_pattern == (
        (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP), (MAMBA, MOE), (ATTN, MLP))
    assert _prefix(ref_config(ARCH)).n_blocks == 1


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------
def _scan_inputs(seq, seed):
    rng = np.random.default_rng(seed)
    din, n = 16, 4
    x = rng.standard_normal((B, seq, din)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, seq, din)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((din, n))).astype(np.float32)
    b, c = (rng.standard_normal((B, seq, n)).astype(np.float32)
            for _ in range(2))
    h0 = rng.standard_normal((B, din, n)).astype(np.float32)
    return x, delta, A, b, c, h0


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("seq", [1, 37, 64, 100])
def test_selective_scan_matches_reference(chunk, seq):
    """From a nonzero state, at S = 1, at lengths the chunk does not
    divide (37 is prime: chunks 8 and 32 shrink to 1; 100 at chunk 8
    shrinks to 5, at 32 to 25, at 64 to 50) and at 64."""
    args = _scan_inputs(seq, seed=seq + chunk)
    y, h = RM.selective_scan_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, th = selective_scan_chunked(*map(_t, args), chunk=chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert ty.shape == (B, seq, 16) and th.shape == (B, 16, 4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **SCAN_TOL)


def test_selective_scan_does_not_depend_on_the_chunk():
    """Every chunk walks the same positions in the same order, one
    multiply-add a position: the states bit for bit; the outputs' sums
    over N, batched by chunk, within 1e-6."""
    args = tuple(map(_t, _scan_inputs(96, seed=5)))
    y, h = selective_scan_chunked(*args, chunk=96)
    for chunk in (1, 8, 32, 48):
        ty, th = selective_scan_chunked(*args, chunk=chunk)
        assert torch.equal(th, h), chunk
        torch.testing.assert_close(ty, y, atol=1e-6, rtol=1e-6)


def test_selective_scan_does_not_underflow_over_a_chunk():
    """Decays whose product over a chunk underflows fp32 (delta A ~ -60 a
    position) leave finite states equal to the reference's."""
    x, delta, A, b, c, h0 = _scan_inputs(32, seed=9)
    delta = np.full_like(delta, 30.0)
    A = np.full_like(A, -2.0)
    args = (x, delta, A, b, c, h0)
    y, h = RM.selective_scan_chunked(*map(jnp.asarray, args), chunk=32)
    ty, th = selective_scan_chunked(*map(_t, args), chunk=32)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(th).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **SCAN_TOL)


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------
D_MODEL, D_STATE = 32, 8


@pytest.fixture(scope="module")
def mixers():
    """(reference Mamba, its params, the port's Mamba with them)."""
    ref = RM.Mamba(d_model=D_MODEL, d_state=D_STATE)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(3)))
    port = Mamba(D_MODEL, D_STATE, device="cpu")
    port.load_state_dict({k: _t(v) for k, v in params.items()})
    return ref, params, port


def _x(seed, seq):
    return np.random.default_rng(seed).standard_normal(
        (B, seq, D_MODEL)).astype(np.float32)


def _close_state(got, want):
    assert sorted(got) == sorted(want) == ["conv", "ssm"]
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def test_mamba_parameters_are_the_reference_tree(mixers):
    _ref, params, port = mixers
    got = {k: v for k, v in port.state_dict().items()}
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        assert tuple(got[k].shape) == v.shape, k
    bf16 = Mamba(D_MODEL, D_STATE, dtype=torch.bfloat16, device="cpu")
    kinds = {k: v.dtype for k, v in bf16.state_dict().items()}
    assert {k for k, d in kinds.items() if d == torch.bfloat16} == {
        "in_proj", "x_proj", "out_proj"}


@pytest.mark.parametrize("seq", [1, 2, 40])
def test_mamba_forward_matches_reference(mixers, seq):
    """From zeros: the output, and the state a prefill leaves (the conv
    state the zero-padded input's tail, shorter prompts than the
    convolution included)."""
    ref, params, port = mixers
    x = _x(seq, seq)
    out, st = ref(params, jnp.asarray(x), local_rules())
    tout, tst = port(_t(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **TOL)
    _close_state(tst, st)


@pytest.mark.parametrize("prefill", [2, 5])
def test_mamba_prefill_state_then_decode_matches_reference(mixers, prefill):
    """The prefill's state handed to single-token steps (and to a second
    multi-token call), each step's output and state against the
    reference's."""
    ref, params, port = mixers
    x = _x(11 + prefill, prefill + 4)
    out, st = ref(params, jnp.asarray(x[:, :prefill]), local_rules())
    tout, tst = port(_t(x[:, :prefill]))
    for t in range(prefill, prefill + 3):
        out, st = ref(params, jnp.asarray(x[:, t:t + 1]), local_rules(),
                      state=st)
        tout, tst = port(_t(x[:, t:t + 1]), state=tst)
        assert tout.shape == (B, 1, D_MODEL)
        np.testing.assert_allclose(tout.numpy(), np.asarray(out), **TOL)
        _close_state(tst, st)
    t = prefill + 3
    out, st = ref(params, jnp.asarray(x[:, t:]), local_rules(), state=st)
    tout, tst = port(_t(x[:, t:]), state=tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **TOL)
    _close_state(tst, st)


def test_mamba_decode_matches_its_forward(mixers):
    """The port alone: a prefill then single-token steps give the full
    sequence's outputs."""
    _ref, _params, port = mixers
    x = _t(_x(21, 9))
    full, _ = port(x)
    out, st = port(x[:, :3])
    outs = [out]
    for t in range(3, 9):
        out, st = port(x[:, t:t + 1], state=st)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_mamba_reset_draws_the_reference_distributions():
    """A_log, D and the conv bias are the reference's constants; dt's bias
    is the inverse softplus of a log-uniform draw over [1e-3, 0.1] (its
    softplus inside the range, spread over it); the projections' spreads
    are the reference's."""
    din = 2 * 64
    port = Mamba(64, D_STATE, device="cpu")
    port.reset(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(np.asarray, RM.Mamba(
        d_model=64, d_state=D_STATE).init(jax.random.PRNGKey(0)))
    got = {k: v.numpy() for k, v in port.state_dict().items()}
    for k in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    dt = np.log1p(np.exp(got["dt_bias"]))
    assert dt.shape == (din,) and 1e-3 <= dt.min() and dt.max() <= 0.1
    assert np.log(dt).std() / np.log(0.1 / 1e-3) > 0.2
    for k in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        assert abs(got[k].std() / want[k].std() - 1) < 0.15, k


# ---------------------------------------------------------------------------
# jamba as a whole LM
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def params():
    ref = build_model(ref_reduced_config(ARCH), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))


def _pair(params, cut=None):
    """(reference jamba-reduced, the port's), the whole block or its
    first ``cut`` sublayers (the leading slice of each stacked leaf)."""
    ref_cfg, cfg = ref_reduced_config(ARCH), get_reduced_config(ARCH)
    if cut is not None:
        ref_cfg, cfg = _prefix(ref_cfg, cut), _prefix(cfg, cut)
        params = {k: v for k, v in params.items() if k != "blocks"} | {
            "blocks": {f"sub{i}": params["blocks"][f"sub{i}"]
                       for i in range(cut)}}
    ref = build_model(ref_cfg, local_rules(), compute_dtype=jnp.float32,
                      param_dtype=jnp.float32)
    return ref, params, lm_from_numpy(cfg, params, device="cpu")


@pytest.mark.parametrize("cut", [None, 5])
def test_hidden_and_logits_match_reference(params, cut):
    """The whole block and the five-sublayer prefix the full config is
    served at: hidden states, logits and the MoE sublayers' loss."""
    ref, p, port = _pair(params, cut)
    tokens = _tokens(port.cfg, 0)
    h, aux, _ = ref.hidden(p, jnp.asarray(tokens))
    want = ref.logits(p, h)
    th, taux, _ = port.hidden(_t(tokens).long())
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    assert abs(float(taux) - float(aux)) <= 1e-6
    err = float(np.abs(port.logits(th).numpy() - np.asarray(want)).max())
    assert err <= LOGIT_REL * float(jnp.abs(want).max())


def test_cache_holds_mamba_states_and_its_length_reads_attention(params):
    """``init_cache`` gives each Mamba sublayer zero conv and SSM states,
    the attention sublayer its K/V; the prefill's states pass through
    ``pad_cache`` as they are; ``launch.serve.cache_length`` reads the
    attention sublayer's buffers."""
    _ref, p, port = _pair(params, 5)
    cfg = port.cfg
    cache = port.init_cache(B, S)
    m = cache[0]["sub0"]["mixer"]
    din = cfg.mamba_d_inner
    assert m["conv"].shape == (B, cfg.mamba_d_conv - 1, din)
    assert m["ssm"].shape == (B, din, cfg.mamba_d_state)
    assert not any(t.any() for t in m.values())
    assert cache[0]["sub4"]["mixer"]["k"].shape == (B, S, cfg.n_kv_heads,
                                                    cfg.hd)
    assert serve.cache_length(cache, cfg) == S
    kvs, _ = port.prefill(_t(_tokens(cfg, 1)[:, :S1]).long())
    padded = port.pad_cache(kvs, S1, S)
    assert padded[0]["sub0"]["mixer"] is kvs[0]["sub0"]["mixer"]
    assert serve.cache_length(padded, cfg) == S


def test_tensor_pos_decode_is_host_int_decode_bit_for_bit(params):
    """The position as a device tensor (as ``DecodeGraph`` passes it)
    decodes as the int does, states and K/V alike."""
    port = _pair(params, 5)[2]
    tokens = _t(_tokens(port.cfg, 9)).long()
    runs = []
    for as_tensor in (False, True):
        cache, _ = port.prefill(tokens[:, :S1], max_seq=S)
        logits = []
        for t in range(S1, S):
            pos = torch.tensor([t], dtype=torch.int32) if as_tensor else t
            cache, lg = port.decode(cache, tokens[:, t:t + 1], pos)
            logits.append(lg)
        runs.append((torch.cat(logits, 1),
                     [t for _, t in serve._leaves(cache)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_prefix_decode_matches_forward():
    """The five-sublayer prefix alone, as the chip's fp32 check runs it:
    prefill S1 tokens, decode the rest, against the full forward (MoE
    dropless)."""
    cfg = dataclasses.replace(_prefix(get_reduced_config(ARCH)),
                              capacity_factor=8.0)
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = _t(_tokens(cfg, 3)).long()
    full = model.logits(model.hidden(tokens)[0])
    cache, last = model.prefill(tokens[:, :S1], max_seq=S)
    errs = [float((last[:, 0] - full[:, S1 - 1]).abs().max())]
    for t in range(S1, S):
        cache, lg = model.decode(cache, tokens[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < DECODE_REL, errs


def test_serve_loop_tokens_equal_the_reference_loop(params):
    """``serve_tokens`` against the reference launcher's loop (prefill
    with room for P + gen, then ``jax.jit(model.decode)``), on a seed whose
    greedy choices are well posed."""
    ref, p, port = _pair(params)
    prompts, gen = _tokens(port.cfg, 12, (B, 6)), 6
    P = prompts.shape[1]
    cache, last = ref.prefill(p, jnp.asarray(prompts), max_seq=P + gen)
    decode = jax.jit(ref.decode)
    tok = jnp.argmax(last[:, -1, :], -1)[:, None].astype(jnp.int32)
    outs, margins = [tok], [jnp.diff(jnp.sort(last[:, -1], -1)[:, -2:])]
    for i in range(gen - 1):
        cache, logits = decode(p, cache, tok, P + i)
        margins.append(jnp.diff(jnp.sort(logits[:, -1], -1)[:, -2:]))
        tok = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
        outs.append(tok)
    assert float(jnp.min(jnp.stack(margins))) > MARGIN
    res = serve.serve_tokens(port, torch.from_numpy(prompts), gen)
    assert res.graph is None and res.finite
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.asarray(jnp.concatenate(outs, axis=1)))


def test_main_serves_jamba_on_the_cpu(capsys):
    argv = ["--arch", "jamba-1.5-large-398b", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "5", "--gen", "4"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    for what in ("[serve] jamba-1.5-large-398b", "prefill:", "decode: p50=",
                 "sample:", "eager"):
        assert what in out
