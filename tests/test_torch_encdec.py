"""The port's encoder-decoder LM and seamless-m4t-large-v2 against the
reference, on the CPU.

seamless-reduced (2 encoder and 2 decoder layers, d 128, 4 heads of hd
32, LayerNorm and GELU, no rotary) in fp32, with the reference's weights
from ``model.init(PRNGKey(0))`` carried across by ``lm_from_numpy``;
tokens and the frontend stub's frames (0.3 * N(0, 1), (B, 12, 128)) from
numpy seeds; one torch thread. Bounds, as ``tests/test_torch_lm.py`` and
``tests/test_torch_xattn.py``: hidden states and caches atol 1e-5, rtol
1e-4 (fp32 sums in other orders); logits within 1e-4 of the reference's
largest |logit|; decode against the port's own forward within the
reference's 2e-3 (``tests/test_models.py``); greedy tokens identical on
seeds whose top-two logits stay more than 1e-3 apart; sinusoidal
positions within 1e-6 at the reduced width and within 1e-4 at 2,048
positions of d 1024 (fp32 sines of angles up to 2,047, whose ulp is
1.2e-4, by two libraries).
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
from repro_torch.launch import serve
from repro_torch.models import EncDecLM
from repro_torch.models import layers as L
from repro_torch.serve import steps
from repro_torch.weights import lm_from_numpy, lm_to_numpy

ARCH = "seamless_m4t_large_v2"
B, S, S1, ENC = 2, 8, 4, 12
LOGIT_REL, DECODE_REL, MARGIN = 1e-4, 2e-3, 1e-3
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    ref = build_model(ref_reduced_config(ARCH), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))


def _pair(params):
    """(reference model, the port's model) on the same weights."""
    ref = build_model(ref_reduced_config(ARCH), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    return ref, lm_from_numpy(get_reduced_config(ARCH), params,
                              device="cpu")


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, seed, n=ENC):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


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
    got, want = _flat_port_cache(got), _flat_ref_cache(want)
    assert sorted(got) == sorted(want)
    assert {"sub0/mixer/k", "sub0/cross/k", "sub0/cross/v"} <= set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


# ---------------------------------------------------------------------------
# the configuration and the positions
# ---------------------------------------------------------------------------
def test_config_is_the_published_one():
    for mine, theirs in ((get_config("seamless-m4t-large-v2"),
                          ref_config(ARCH)),
                         (get_reduced_config(ARCH),
                          ref_reduced_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config(ARCH)
    assert (full.enc_dec, full.d_model, full.hd, full.n_kv_heads,
            full.n_layers, full.padded_vocab, full.norm, full.act) == (
                True, 1024, 64, 16, 24, 256_256, "layernorm", "gelu")


@pytest.mark.parametrize("d_model,n,atol", [(128, 64, 1e-6),
                                            (1024, 2048, 1e-4)])
def test_sinusoidal_positions_match_reference(d_model, n, atol):
    pos = np.arange(n)
    want = RL.sinusoidal_positions(jnp.asarray(pos), d_model, jnp.float32)
    got = L.sinusoidal_positions(_t(pos), d_model, torch.float32)
    assert got.shape == (n, d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)
    one = L.sinusoidal_positions(torch.tensor([n - 1], dtype=torch.int32),
                                 d_model, torch.bfloat16)
    assert one.dtype == torch.bfloat16
    assert torch.equal(one, got[n - 1:].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
def test_encoder_matches_reference(params):
    """Sinusoidal positions on the frames, the non-causal encoder, its
    norm; a frame late in the stream changes the output at the first
    position (no causal mask)."""
    ref, port = _pair(params)
    frames = _frames(port.cfg, 1)
    want, aux = ref.encode(params, jnp.asarray(frames))
    got, taux = port.encode(_t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(taux) == float(aux) == 0.0
    late = frames.copy()
    late[:, -1] += 1.0
    assert not torch.allclose(port.encode(_t(late))[0][:, 0], got[:, 0])


def test_hidden_and_logits_match_reference(params):
    ref, port = _pair(params)
    tokens, frames = _tokens(port.cfg, 2), _frames(port.cfg, 3)
    h, _aux, _ = ref.hidden(params, jnp.asarray(tokens),
                            {"frames": jnp.asarray(frames)})
    want = ref.logits(params, h)
    th, _taux, kvs = port.hidden(_t(tokens).long(), {"frames": _t(frames)})
    assert kvs is None
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    _close_logits(port.logits(th), want, float(jnp.abs(want).max()))
    with pytest.raises(ValueError, match="frames"):
        port.hidden(_t(tokens).long())


def test_prefill_and_decode_match_reference(params):
    """Prefill's cache (the self K/V padded to S, every decoder layer's
    cross K/V over the frames) and last logits, then each decode step's
    logits and the cache after the last one."""
    ref, port = _pair(params)
    tokens, frames = _tokens(port.cfg, 4), _frames(port.cfg, 5)
    h, _, _ = ref.hidden(params, jnp.asarray(tokens),
                         {"frames": jnp.asarray(frames)})
    scale = float(jnp.abs(ref.logits(params, h)).max())
    cache, last = ref.prefill(params, jnp.asarray(tokens[:, :S1]),
                              {"frames": jnp.asarray(frames)}, max_seq=S)
    tcache, tlast = port.prefill(_t(tokens[:, :S1]).long(),
                                 {"frames": _t(frames)}, max_seq=S)
    _close_logits(tlast, last, scale)
    _close_caches(tcache, cache)
    assert tcache[0]["sub0"]["cross"]["k"].shape[1] == ENC
    for t in range(S1, S):
        cache, lg = ref.decode(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                               t)
        tcache, tlg = port.decode(tcache, _t(tokens[:, t:t + 1]).long(), t)
        assert tlg.shape == (B, 1, port.cfg.padded_vocab)
        _close_logits(tlg, lg, scale)
    _close_caches(tcache, cache)


def test_serving_steps_take_the_frames(params):
    """``make_prefill_step`` with ``batch["frames"]``, then
    ``make_decode_step``: the reference's steps' tokens and logits."""
    ref, port = _pair(params)
    tokens, frames = _tokens(port.cfg, 6), _frames(port.cfg, 7)
    ref_pre = ref_steps.make_prefill_step(ref, ref.cfg, None)
    ref_dec = ref_steps.make_decode_step(ref, ref.cfg, None)
    pre = steps.make_prefill_step(port, port.cfg, max_seq=S)
    dec = steps.make_decode_step(port, port.cfg)
    cache, last = ref_pre(params, {"tokens": jnp.asarray(tokens[:, :S1]),
                                   "frames": jnp.asarray(frames)})
    cache = ref.decoder.pad_cache(cache, S1, S)  # its step leaves no room
    tcache, tlast = pre({"tokens": _t(tokens[:, :S1]).long(),
                         "frames": _t(frames)})
    scale = float(jnp.abs(last).max())
    _close_logits(tlast, last, scale)
    for t in range(S1, S):
        cache, nxt, lg = ref_dec(params, cache,
                                 jnp.asarray(tokens[:, t:t + 1]), t)
        tcache, tnxt, tlg = dec(tcache, _t(tokens[:, t:t + 1]).long(), t)
        assert tnxt.dtype == torch.int32
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(nxt))
        _close_logits(tlg, lg, scale)
    with pytest.raises(ValueError, match="frames"):
        pre({"tokens": _t(tokens[:, :S1]).long()})


def test_greedy_generate_matches_reference(params):
    """The reference's token-by-token loop from ``init_cache`` (cross
    buffers of zeros, as its decode cells size them): the same tokens."""
    ref, port = _pair(params)
    prompt, n_new = _tokens(port.cfg, 8, (B, 5)), 4
    got = steps.greedy_generate(port, _t(prompt).long(), n_new)
    want = ref_steps.greedy_generate(ref, params, jnp.asarray(prompt), n_new)
    assert got.shape == (B, n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cache = port.init_cache(B, 9)
    assert cache[0]["sub0"]["cross"]["k"].shape[1] == 9
    assert not any(t.any() for _, t in serve._leaves(cache))


def test_serve_loop_tokens_equal_the_reference_loop(params):
    """``serve_tokens`` with the frames in ``extras`` against the reference
    launcher's loop (prefill with room for P + gen, then
    ``jax.jit(model.decode)``), on a seed whose greedy choices are well
    posed."""
    ref, port = _pair(params)
    prompts, gen = _tokens(port.cfg, 12, (B, 6)), 6
    frames = _frames(port.cfg, 13)
    P = prompts.shape[1]
    cache, last = ref.prefill(params, jnp.asarray(prompts),
                              {"frames": jnp.asarray(frames)},
                              max_seq=P + gen)
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
                             extras={"frames": _t(frames)})
    assert res.graph is None and res.finite
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.asarray(jnp.concatenate(outs, axis=1)))


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------
def _model(seed=0):
    return EncDecLM(get_reduced_config(ARCH), compute_dtype=torch.float32,
                    device="cpu", generator=torch.Generator().manual_seed(seed))


def test_decode_matches_forward():
    """Prefill S1 tokens over the frames, decode the rest, against the
    full forward pass."""
    model = _model()
    tokens = _t(_tokens(model.cfg, 14)).long()
    extras = {"frames": _t(_frames(model.cfg, 15))}
    full = model.logits(model.hidden(tokens, extras)[0])
    cache, last = model.prefill(tokens[:, :S1], extras, max_seq=S)
    errs = [float((last[:, 0] - full[:, S1 - 1]).abs().max())]
    for t in range(S1, S):
        cache, lg = model.decode(cache, tokens[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < DECODE_REL, errs


def test_tensor_pos_decode_is_host_int_decode_bit_for_bit():
    """The position as a device tensor (as ``DecodeGraph`` passes it) reads
    the same sinusoid and writes the same K/V as the int; the cross caches
    are the prefill's tensors, never rewritten; ``cache_length`` reads the
    self-attention buffers."""
    model = _model()
    tokens = _t(_tokens(model.cfg, 16)).long()
    extras = {"frames": _t(_frames(model.cfg, 17))}
    runs = []
    for as_tensor in (False, True):
        cache, _ = model.prefill(tokens[:, :S1], extras, max_seq=S)
        cross = cache[0]["sub0"]["cross"]["k"]
        logits = []
        for t in range(S1, S):
            pos = torch.tensor([t], dtype=torch.int32) if as_tensor else t
            cache, lg = model.decode(cache, tokens[:, t:t + 1], pos)
            logits.append(lg)
        assert cache[0]["sub0"]["cross"]["k"] is cross
        assert serve.cache_length(cache, model.cfg) == S
        runs.append((torch.cat(logits, 1),
                     [t for _, t in serve._leaves(cache)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_weights_round_trip_exactly(params):
    """The reference's tree (``encoder/...`` and ``decoder/...`` stacked
    over the blocks, the decoder's ``cross`` and ``norm_x`` included), key
    for key and bit for bit, and back."""
    cfg = get_reduced_config(ARCH)
    flat = lm_to_numpy(lm_from_numpy(cfg, params, device="cpu"))
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)}
    assert sorted(flat) == sorted(want)
    assert {"decoder/sub0/cross/wq/w", "decoder/sub0/norm_x/bias",
            "encoder/sub0/mixer/wk/w", "enc_norm/scale",
            "lm_head/w"} <= set(flat)
    for key, v in want.items():
        np.testing.assert_array_equal(flat[key], v, err_msg=key)
    again = lm_to_numpy(lm_from_numpy(cfg, flat, device="cpu"))
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


def test_init_draws_the_reference_distributions():
    """``EncDecLM``'s init and the reference's give the same tree; each
    leaf has the reference's constants or the spread of its distribution
    (the generators differ, so values do)."""
    ref = build_model(ref_reduced_config(ARCH), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    want = {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(
                ref.init(jax.random.PRNGKey(0)))}
    got = lm_to_numpy(_model())
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert abs(g.std() / w.std() - 1) < 0.15, key
            assert abs(g.mean()) < 0.2 * w.std() + 1e-3, key


def test_main_serves_seamless_on_the_cpu(capsys):
    argv = ["--arch", "seamless-m4t-large-v2", "--reduced", "--device",
            "cpu", "--requests", "2", "--prompt-len", "5", "--gen", "4"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    for what in ("[serve] seamless-m4t-large-v2", "prefill:", "decode: p50=",
                 "sample:", "eager"):
        assert what in out
