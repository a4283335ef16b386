"""The port's cross-attention (XATTN) and llama-3.2-vision-90b against the
reference, on the CPU.

llama-vision-reduced (5 layers: four ATTN + MLP, then XATTN + MLP; d 128,
8 heads over 2 KV heads, 32 image tokens) in fp32, with the reference's
weights from ``model.init(PRNGKey(0))`` carried across by
``lm_from_numpy``; tokens and the context (0.3 * N(0, 1), (B, 32, 128))
from numpy seeds; one torch thread. Bounds, as ``tests/test_torch_lm.py``
and ``tests/test_torch_serve_lm.py``: attention outputs and caches atol
1e-5, rtol 1e-4 (fp32 sums in other orders); logits within 1e-4 of the
reference's largest |logit|; int8 cache values equal but where a value
lies within rounding of a half step (at most one step, under 1% of
them); decode against the port's own forward within the reference's
2e-3 (5e-2 on the int8 cache, ``tests/test_models.py``); greedy tokens
identical on seeds whose top-two logits stay more than 1e-3 apart.
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
from repro.models import layers as RL
from repro.models.transformer import build_model
from repro.serve import steps as ref_steps
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ATTN, MLP, XATTN
from repro_torch.launch import serve
from repro_torch.models import DecoderLM
from repro_torch.models import layers as L
from repro_torch.serve import steps
from repro_torch.weights import lm_from_numpy, lm_to_numpy

ARCH = "llama3_2_vision_90b"
B, S, S1 = 2, 8, 4
LOGIT_REL = 1e-4
DECODE_REL, INT8_REL = 2e-3, 5e-2
MARGIN = 1e-3
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(int8):
    ref_cfg, cfg = ref_reduced_config(ARCH), get_reduced_config(ARCH)
    if int8:
        ref_cfg = dataclasses.replace(ref_cfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return ref_cfg, cfg


@pytest.fixture(scope="module")
def params():
    ref = build_model(ref_reduced_config(ARCH), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))


def _pair(params, int8=False):
    """(reference model, the port's model) on the same weights."""
    ref_cfg, cfg = _configs(int8)
    ref = build_model(ref_cfg, local_rules(), compute_dtype=jnp.float32,
                      param_dtype=jnp.float32)
    return ref, lm_from_numpy(cfg, params, device="cpu")


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _context(cfg, seed, batch=B):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def _t(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 \
        else torch.from_numpy(x)


def _close_logits(got, want, scale):
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= LOGIT_REL * scale, (err, scale)


def _flat_ref_cache(cache):
    return {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(cache)}


def _flat_port_cache(cache):
    flat = {}
    for block in cache:
        for path, t in serve._leaves(block):
            flat.setdefault("/".join(path), []).append(t.numpy())
    return {k: np.stack(v) for k, v in flat.items()}


def _close_caches(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        if got[key].dtype == np.int8:  # at most one step, rarely
            diff = np.abs(got[key].astype(int) - want[key].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, key
        else:
            np.testing.assert_allclose(got[key], want[key], **TOL,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------
def test_config_is_the_published_one():
    for mine, theirs in ((get_config("llama-3.2-vision-90b"),
                          ref_config(ARCH)),
                         (get_reduced_config(ARCH),
                          ref_reduced_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config(ARCH)
    assert (full.hd, full.n_heads // full.n_kv_heads, full.kv_cache_dtype,
            full.n_frontend_tokens, full.n_blocks) == (128, 8, "int8", 6404,
                                                       20)
    assert full.block_pattern[-1] == (XATTN, MLP)


# ---------------------------------------------------------------------------
# chunked attention and the cross Attention layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,chunk,Sq,Sk", [(True, 512, 12, 12),
                                                (True, 4, 12, 12),
                                                (False, 512, 12, 20),
                                                (False, 3, 12, 20),
                                                (False, 5, 12, 20)])
def test_chunked_attention_matches_reference(causal, chunk, Sq, Sk):
    """Head-expanded K/V as the reference passes them, at its chunk and
    at others (5 does not divide 12: one block); the port's unexpanded
    K/V (4 query heads over 2 KV heads) give the same."""
    rng = np.random.default_rng(Sq + Sk + chunk)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    ke, ve = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    want = np.asarray(RL.chunked_attention(
        jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve), causal=causal,
        q_chunk=chunk))
    for kk, vv in ((ke, ve), (k, v)):
        got = L.chunked_attention(_t(q), _t(kk), _t(vv), causal=causal,
                                  q_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dims,chunk", [((16, 64, 1024, 6404), 32),
                                        ((16, 64, 1024, 1024), 256),
                                        ((16, 15, 1024, 1024), 512),
                                        ((2, 8, 8, 32), 8),
                                        ((16, 64, 1000, 6404), 40),
                                        ((16, 64, 1031, 6404), 1)])
def test_query_chunk_divides_and_keeps_the_scores_within_a_gib(dims, chunk):
    """The chunk of llama-3.2-vision-90b's cross layers at batch 16 over
    6,404 image tokens is 32 (0.84 GB of fp32 scores), its self layers'
    256; smollm's stays the reference's 512; a prime length gets 1."""
    Bn, H, Sq, Sk = dims
    c = L.query_chunk(Bn, H, Sq, Sk)
    assert c == chunk and Sq % c == 0 and c <= 512
    assert 4 * Bn * H * c * Sk <= L.SCORE_BYTES or c == 1


def test_chunked_attention_does_not_depend_on_the_chunk():
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((2, 24, 4, 16)).astype(np.float32))
    k, v = (_t(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
            for _ in range(2))
    for causal in (True, False):
        want = L.chunked_attention(q, k, v, causal=causal, q_chunk=24)
        for c in (1, 6, 8, 12):
            got = L.chunked_attention(q, k, v, causal=causal, q_chunk=c)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                       rtol=1e-6)


def _cross_pair():
    """The reference's cross Attention (as its XATTN sublayer builds it),
    its params, and the port's on the same weights."""
    ref = RL.Attention(d_model=32, n_heads=8, n_kv_heads=2, head_dim=16,
                       rope_theta=0.0, causal=False, cross=True)
    p = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(3)))
    port = L.Attention(32, 8, 2, 16, rope_theta=0.0, cross=True,
                       device="cpu")
    port.load_state_dict({f"{n}.w": torch.from_numpy(p[n]["w"].copy())
                          for n in ("wq", "wk", "wv", "wo")})
    return ref, p, port


def test_cross_attention_forward_matches_reference():
    ref, p, port = _cross_pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    ctx = (0.3 * rng.standard_normal((2, 11, 32))).astype(np.float32)
    out, (k, v) = ref(p, jnp.asarray(x), local_rules(),
                      context=jnp.asarray(ctx), return_kv=True)
    got, (tk, tv) = port(_t(x), context=_t(ctx), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert tk.shape == (2, 11, 2, 16)  # the context's, in the cache layout
    np.testing.assert_allclose(tk.numpy(), np.asarray(k), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), **TOL)
    with pytest.raises(ValueError, match="context"):
        port(_t(x))


@pytest.mark.parametrize("int8", [False, True])
def test_cross_attention_decode_matches_reference(int8):
    """One token against the whole context cache, unmasked, on the same
    cache in both packages (the int8 form as the port quantized it); the
    port writes nothing and returns the very tensors it was given,
    whatever ``pos``."""
    ref, p, port = _cross_pair()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
            for _ in range(2))
    tk, tv = _t(k), _t(v)
    if int8:
        tk, tv = L.quantize_kv(tk), L.quantize_kv(tv)
        jk, jv = ({n: jnp.asarray(c[n].numpy()) for n in ("q", "s")}
                  for c in (tk, tv))
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    before = [t.clone() for _, t in serve._leaves([tk, tv])]
    want, _, _ = ref.decode(p, jnp.asarray(x), jk, jv, 3, local_rules())
    for pos in (3, torch.tensor([0], dtype=torch.int32)):
        got, ok, ov = port.decode(_t(x), tk, tv, pos)
        assert ok is tk and ov is tv
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    after = [t for _, t in serve._leaves([tk, tv])]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_hidden_matches_reference(params):
    ref, port = _pair(params)
    tokens, ctx = _tokens(port.cfg, 0), _context(port.cfg, 1)
    h, _, _ = ref.hidden(params, jnp.asarray(tokens),
                         {"context": jnp.asarray(ctx)})
    want = ref.logits(params, h)
    th, aux, kvs = port.hidden(_t(tokens), {"context": _t(ctx)})
    assert kvs is None and float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    _close_logits(port.logits(th), want, float(jnp.abs(want).max()))
    with pytest.raises(ValueError, match="context"):
        port.hidden(_t(tokens))


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_and_decode_match_reference(params, int8):
    """Prefill's caches (the self layers' padded to S, the cross layer's
    the context's 32 positions) and last logits, then four decode steps'
    logits (a device-tensor pos) and the caches after them."""
    ref, port = _pair(params, int8)
    tokens, ctx = _tokens(port.cfg, 1), _context(port.cfg, 2)
    ext = {"context": jnp.asarray(ctx)}
    h, _, _ = ref.hidden(params, jnp.asarray(tokens), ext)
    scale = float(jnp.abs(ref.logits(params, h)).max())
    cache, last = ref.prefill(params, jnp.asarray(tokens[:, :S1]), ext,
                              max_seq=S)
    tcache, tlast = port.prefill(_t(tokens[:, :S1]), {"context": _t(ctx)},
                                 max_seq=S)
    _close_logits(tlast, last, scale)
    got = _flat_port_cache(tcache)
    _close_caches(got, _flat_ref_cache(cache))
    key = "sub4/mixer/k/q" if int8 else "sub4/mixer/k"
    assert got[key].shape[2] == port.cfg.n_frontend_tokens
    for t in range(S1, S):
        cache, lg = ref.decode(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                               t)
        tcache, tlg = port.decode(tcache, _t(tokens[:, t:t + 1]),
                                  torch.tensor([t], dtype=torch.int32))
        _close_logits(tlg, lg, scale)
    _close_caches(_flat_port_cache(tcache), _flat_ref_cache(cache))


@pytest.mark.parametrize("int8", [False, True])
def test_decode_matches_forward(int8):
    """The port alone, as the reference's test_decode_matches_forward and
    test_int8_kv_cache_decode (which runs this arch): prefill S1 tokens,
    decode the rest, against the full forward pass."""
    cfg = _configs(int8)[1]
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = _t(_tokens(cfg, 3))
    ext = {"context": _t(_context(cfg, 4))}
    full = model.logits(model.hidden(tokens, ext)[0])
    cache, last = model.prefill(tokens[:, :S1], ext, max_seq=S)
    errs = [float((last[:, 0] - full[:, S1 - 1]).abs().max())]
    for t in range(S1, S):
        cache, lg = model.decode(cache, tokens[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    bound = INT8_REL if int8 else DECODE_REL
    assert max(errs) / float(full.abs().max()) < bound, errs


def test_serving_steps_pass_the_context(params):
    """``make_prefill_step`` with ``batch["context"]``, then
    ``make_decode_step``: the reference's steps' tokens and logits; no
    context raises ``ValueError`` as the reference's ``_extras``. The step
    passes ``batch["frames"]`` on as the reference's does, and the VLM, a
    decoder-only model, leaves them unread: the same cache and logits."""
    ref, port = _pair(params)
    tokens, ctx = _tokens(port.cfg, 2), _context(port.cfg, 3)
    ref_pre = ref_steps.make_prefill_step(ref, ref.cfg, None)
    ref_dec = ref_steps.make_decode_step(ref, ref.cfg, None)
    pre = steps.make_prefill_step(port, port.cfg, max_seq=S)
    dec = steps.make_decode_step(port, port.cfg)
    cache, last = ref_pre(params, {"tokens": jnp.asarray(tokens[:, :S1]),
                                   "context": jnp.asarray(ctx)})
    cache = ref.stack.pad_cache(cache, S1, S)  # its step leaves no room
    tcache, tlast = pre({"tokens": _t(tokens[:, :S1]), "context": _t(ctx)})
    scale = float(jnp.abs(last).max())
    _close_logits(tlast, last, scale)
    for t in range(S1, S):
        cache, nxt, lg = ref_dec(params, cache,
                                 jnp.asarray(tokens[:, t:t + 1]), t)
        tcache, tnxt, tlg = dec(tcache, _t(tokens[:, t:t + 1]), t)
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(nxt))
        _close_logits(tlg, lg, scale)
    with pytest.raises(ValueError, match="context"):
        pre({"tokens": _t(tokens[:, :S1])})
    with pytest.raises(ValueError, match="context"):
        pre({"tokens": _t(tokens[:, :S1]), "frames": _t(ctx)})
    fcache, flast = pre({"tokens": _t(tokens[:, :S1]), "context": _t(ctx),
                         "frames": _t(ctx)})
    again, alast = pre({"tokens": _t(tokens[:, :S1]), "context": _t(ctx)})
    assert torch.equal(flast, alast)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        serve._leaves(fcache), serve._leaves(again)))


def test_serve_loop_tokens_equal_the_reference_loop(params):
    """``serve_tokens`` with the context in ``extras`` against the
    reference launcher's loop (prefill with room for P + gen, then
    ``jax.jit(model.decode)``), on a seed whose greedy choices are well
    posed."""
    ref, port = _pair(params)
    prompts, gen = _tokens(port.cfg, 12, (B, 6)), 6
    ctx = _context(port.cfg, 13)
    P = prompts.shape[1]
    cache, last = ref.prefill(params, jnp.asarray(prompts),
                              {"context": jnp.asarray(ctx)}, max_seq=P + gen)
    decode = jax.jit(ref.decode)
    tok = jnp.argmax(last[:, -1, :], -1)[:, None].astype(jnp.int32)
    outs, margins = [tok], [jnp.diff(jnp.sort(last[:, -1], -1)[:, -2:])]
    for i in range(gen - 1):
        cache, logits = decode(params, cache, tok, P + i)
        margins.append(jnp.diff(jnp.sort(logits[:, -1], -1)[:, -2:]))
        tok = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
        outs.append(tok)
    assert float(jnp.min(jnp.stack(margins))) > MARGIN
    res = serve.serve_tokens(port, torch.from_numpy(prompts), gen,
                             extras={"context": _t(ctx)})
    assert res.graph is None and res.finite
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.asarray(jnp.concatenate(outs, axis=1)))


def test_caches_hold_the_context_and_cache_length_reads_self_attention():
    """``init_cache`` gives the XATTN entries ``n_frontend_tokens``
    positions, ``pad_cache`` leaves them as they are, and
    ``launch.serve.cache_length`` reads a self-attention buffer even where
    the pattern's first K/V leaf is a cross cache."""
    cfg = dataclasses.replace(get_reduced_config(ARCH), n_layers=2,
                              block_pattern=((XATTN, MLP), (ATTN, MLP)),
                              kv_cache_dtype="int8")
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    cache = model.init_cache(B, S)
    assert cache[0]["sub0"]["mixer"]["k"]["q"].shape[1] == 32
    assert cache[0]["sub1"]["mixer"]["v"]["s"].shape[1] == S
    assert serve.cache_length(cache, cfg) == S
    tokens, ctx = _t(_tokens(cfg, 5)), _t(_context(cfg, 6))
    kvs, _ = model.prefill(tokens[:, :S1], {"context": ctx})
    padded = model.pad_cache(kvs, S1, S)
    assert padded[0]["sub0"]["mixer"] is kvs[0]["sub0"]["mixer"]
    assert padded[0]["sub1"]["mixer"]["k"]["q"].shape[1] == S
    assert serve.cache_length(padded, cfg) == S
    rwkv = get_reduced_config("rwkv6_1b6")
    assert serve.cache_length(DecoderLM(rwkv, device="cpu").init_cache(
        B, S), rwkv) is None


def test_weights_round_trip_exactly(params):
    """The reference's tree, ``blocks/sub4/mixer/{wq,wk,wv,wo}`` (the
    cross layer) included, key for key and bit for bit, and back."""
    cfg = get_reduced_config(ARCH)
    flat = lm_to_numpy(lm_from_numpy(cfg, params, device="cpu"))
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)}
    assert sorted(flat) == sorted(want)
    assert {f"blocks/sub4/mixer/{n}/w" for n in ("wq", "wk", "wv", "wo")} \
        <= set(flat)
    for key, v in want.items():
        np.testing.assert_array_equal(flat[key], v, err_msg=key)
    again = lm_to_numpy(lm_from_numpy(cfg, flat, device="cpu"))
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


def test_main_serves_the_vlm_on_the_cpu(capsys):
    argv = ["--arch", "llama-3.2-vision-90b", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "5", "--gen", "4"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    for what in ("[serve] llama-3.2-vision-90b", "prefill:", "decode: p50=",
                 "sample:", "eager"):
        assert what in out
