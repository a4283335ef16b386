"""yi-34b and qwen1.5-110b, the last two dense configs ported, against the
reference on the CPU.

Their reduced configurations (yi-reduced: 4 heads over 2 KV heads at hd
32; qwen-reduced: 8 over 2 at hd 16 with qkv biases) in fp32, as
published (a bf16 cache) and on the int8 cache their full configs serve
with, the reference's weights from ``model.init(PRNGKey(0))`` carried
across by ``lm_from_numpy``. Bounds as ``tests/test_torch_lm.py`` and
``tests/test_torch_serve_lm.py``: logits within 1e-4 of the reference's
largest |logit|; fp32 caches atol 1e-5, rtol 1e-4; int8 cache values
equal but where a value lies within rounding of a half step; decode
against the full forward within 2e-3 of its largest |logit| (5e-2 on the
int8 cache, the reference's ``test_int8_kv_cache_decode`` bound).
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
from repro.models.transformer import build_model
from repro.serve import steps as ref_steps
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import serve
from repro_torch.models import DecoderLM
from repro_torch.serve import steps
from repro_torch.weights import lm_from_numpy, lm_to_numpy

ARCHS = ["yi_34b", "qwen1_5_110b"]
CASES = [(arch, int8) for arch in ARCHS for int8 in (False, True)]
B, S, S1 = 2, 8, 4
LOGIT_REL = 1e-4
DECODE_REL, INT8_REL = 2e-3, 5e-2
STATE_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, int8=False):
    """(reference model, its params, the port's model) on shared weights,
    on the int8 cache with ``int8``."""
    ref_cfg, cfg = ref_reduced_config(arch), get_reduced_config(arch)
    if int8:
        ref_cfg = dataclasses.replace(ref_cfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ref = build_model(ref_cfg, local_rules(), compute_dtype=jnp.float32,
                      param_dtype=jnp.float32)
    params = ref.init(jax.random.PRNGKey(0))
    port = lm_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    return ref, params, port


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _t(tokens):
    return torch.from_numpy(tokens).long()


def _close_logits(got, want, scale):
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= LOGIT_REL * scale, (err, scale)


def _flat_ref_cache(cache):
    return {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(cache)}


def _flat_port_cache(cache):
    flat = {}
    for block in cache:
        for path, t in serve._leaves(block):
            flat.setdefault("/".join(path), []).append(t.numpy())
    return {k: np.stack(v) for k, v in flat.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Full and reduced configs field for field, the full ones' shapes:
    yi's 56 heads over 8 (G 7) at hd 128, qwen's 64 over 8 (G 8) at hd 128
    with qkv biases, both on the int8 cache."""
    for mine, theirs in ((get_config(arch), ref_config(arch)),
                         (get_reduced_config(arch),
                          ref_reduced_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config(arch)
    assert (full.hd, full.n_kv_heads, full.kv_cache_dtype) == \
        (128, 8, "int8")
    assert full.n_heads // full.n_kv_heads == {"yi_34b": 7,
                                               "qwen1_5_110b": 8}[arch]
    assert full.qkv_bias == (arch == "qwen1_5_110b")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref, params, port = _pair(arch)
    tokens = _tokens(port.cfg, 0)
    h, _, _ = ref.hidden(params, jnp.asarray(tokens))
    want = ref.logits(params, h)
    th, _, _ = port.hidden(_t(tokens))
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **STATE_TOL)
    _close_logits(port.logits(th), want, float(jnp.abs(want).max()))


@pytest.mark.parametrize("arch,int8", CASES)
def test_prefill_and_decode_match_reference(arch, int8):
    """Prefill's cache (padded to S) and last logits, then each decode
    step's logits and the cache after the last one."""
    ref, params, port = _pair(arch, int8)
    tokens = _tokens(port.cfg, 1)
    h, _, _ = ref.hidden(params, jnp.asarray(tokens))
    scale = float(jnp.abs(ref.logits(params, h)).max())
    cache, last = ref.prefill(params, jnp.asarray(tokens[:, :S1]), max_seq=S)
    tcache, tlast = port.prefill(_t(tokens[:, :S1]), max_seq=S)
    _close_logits(tlast, last, scale)
    for t in range(S1, S):
        cache, lg = ref.decode(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                               t)
        tcache, tlg = port.decode(tcache, _t(tokens[:, t:t + 1]), t)
        assert tlg.shape == (B, 1, port.cfg.padded_vocab)
        _close_logits(tlg, lg, scale)
    want, got = _flat_ref_cache(cache), _flat_port_cache(tcache)
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        if got[key].dtype == np.int8:  # at most one step, rarely
            diff = np.abs(got[key].astype(int) - want[key].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, key
        else:
            np.testing.assert_allclose(got[key], want[key], **STATE_TOL,
                                       err_msg=key)


@pytest.mark.parametrize("arch,int8", CASES)
def test_serving_steps_match_reference(arch, int8):
    """``make_prefill_step`` then ``make_decode_step``: the same greedy
    tokens and logits as the reference's steps, fed the same tokens."""
    ref, params, port = _pair(arch, int8)
    tokens = _tokens(port.cfg, 2)
    ref_pre = ref_steps.make_prefill_step(ref, ref.cfg, None)
    ref_dec = ref_steps.make_decode_step(ref, ref.cfg, None)
    pre = steps.make_prefill_step(port, port.cfg, max_seq=S)
    dec = steps.make_decode_step(port, port.cfg)
    cache, last = ref_pre(params, {"tokens": jnp.asarray(tokens[:, :S1])})
    cache = ref.stack.pad_cache(cache, S1, S)  # its step leaves no room
    tcache, tlast = pre({"tokens": _t(tokens[:, :S1])})
    scale = float(jnp.abs(last).max())
    _close_logits(tlast, last, scale)
    for t in range(S1, S):
        cache, nxt, lg = ref_dec(params, cache,
                                 jnp.asarray(tokens[:, t:t + 1]), t)
        tcache, tnxt, tlg = dec(tcache, _t(tokens[:, t:t + 1]), t)
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(nxt))
        _close_logits(tlg, lg, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    """The same generated tokens; the seed's top-two margins exceed 1e-3
    at every generated position (the logits agree to ~1e-6), so token
    identity is well posed."""
    ref, params, port = _pair(arch)
    prompt, n_new = _tokens(port.cfg, 5, (B, 5)), 4
    got = steps.greedy_generate(port, _t(prompt), n_new)
    want = ref_steps.greedy_generate(ref, params, jnp.asarray(prompt), n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq = _t(np.concatenate([prompt, got.numpy().astype(np.int32)], axis=1))
    logits = port.logits(port.hidden(seq)[0])[:, prompt.shape[1] - 1:-1]
    top2 = torch.topk(logits, 2).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-3


@pytest.mark.parametrize("arch,int8", CASES)
def test_decode_matches_forward(arch, int8):
    """The port alone, as the reference's test_decode_matches_forward and
    test_int8_kv_cache_decode: prefill S1 tokens, decode the rest, against
    the full forward pass."""
    cfg = get_reduced_config(arch)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = _t(_tokens(cfg, 3))
    full = model.logits(model.hidden(tokens)[0])
    cache, last = model.prefill(tokens[:, :S1], max_seq=S)
    errs = [float((last[:, 0] - full[:, S1 - 1]).abs().max())]
    for t in range(S1, S):
        cache, lg = model.decode(cache, tokens[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    bound = INT8_REL if int8 else DECODE_REL
    assert max(errs) / float(full.abs().max()) < bound, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_exactly(arch):
    """The reference's parameter tree (qwen's qkv biases included) carries
    across key for key and back."""
    ref = build_model(ref_reduced_config(arch), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(1)))
    flat = lm_to_numpy(lm_from_numpy(get_reduced_config(arch), params,
                                     device="cpu"))
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)}
    assert sorted(flat) == sorted(want)
    assert any(k.endswith("wq/b") for k in flat) == (arch == "qwen1_5_110b")
    for key, v in want.items():
        np.testing.assert_array_equal(flat[key], v, err_msg=key)
