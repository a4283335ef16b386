"""The port's LM serving path against the reference, on the CPU.

The reduced configurations (smollm-reduced: GQA with G=3, hd 32;
rwkv6-reduced: hd 32; olmoe-reduced: MoE of 8 experts, top-2, hd 32;
moonshot-reduced: MoE of 8 experts of d_ff 96, top-3, hd 32;
jamba-reduced: 7 Mamba and 1 attention sublayer, 4 MLP and 4 MoE of 4
experts, top-2, no rotary) in fp32, with the reference's weights from
``model.init(PRNGKey(0))`` carried across by ``lm_from_numpy`` and tokens
from numpy seeds. On CPU tensors the model's grouped decode attention and
WKV take the kernels' plain versions. Bounds: logits within 1e-4 of the
reference's largest |logit| (fp32, sums in other orders); caches and
states atol 1e-5, rtol 1e-4; decode against the full forward within the
reference's own 2e-3 relative bound (``tests/test_models.py``), MoE at
its dropless capacity factor 8.0 as there; the summed MoE load-balancing
loss within 1e-6 of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.distributed.sharding import local_rules
from repro.models.transformer import build_model
from repro.serve import steps as ref_steps
from repro_torch.configs import get_reduced_config
from repro_torch.models import DecoderLM
from repro_torch.models import layers as L
from repro_torch.serve import steps
from repro_torch.weights import lm_from_numpy, lm_to_numpy

ARCHS = ["smollm_360m", "rwkv6_1b6", "olmoe_1b_7b", "moonshot_v1_16b_a3b",
         "jamba1_5_large_398b"]
B, S, S1 = 2, 8, 4
LOGIT_REL = 1e-4
STATE_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference model, its params, the port's model) on shared weights."""
    arch = request.param
    ref = build_model(ref_reduced_config(arch), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    params = ref.init(jax.random.PRNGKey(0))
    port = lm_from_numpy(get_reduced_config(arch),
                         jax.tree_util.tree_map(np.asarray, params),
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


def _ref_flat_cache(cache):
    """The reference's cache tree as {"sub0/mixer/k": (n_blocks, ...)}."""
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        flat["/".join(p.key for p in path)] = np.asarray(leaf)
    return flat


def _port_flat_cache(cache):
    """The port's per-block cache list, stacked as the reference's."""
    flat = {}
    for block in cache:
        for sub, entry in block.items():
            for part, tensors in entry.items():
                for name, t in tensors.items():
                    flat.setdefault(f"{sub}/{part}/{name}", []).append(
                        t.float().numpy())
    return {k: np.stack(v) for k, v in flat.items()}


def test_forward_matches_reference(pair):
    ref, params, port = pair
    tokens = _tokens(port.cfg, 0)
    h, ref_aux, _ = ref.hidden(params, jnp.asarray(tokens))
    want = ref.logits(params, h)
    th, aux, kvs = port.hidden(_t(tokens))
    assert kvs is None and aux.dtype == torch.float32
    assert abs(float(aux) - float(ref_aux)) <= 1e-6
    assert (float(aux) > 0) == bool(port.cfg.n_experts)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=1e-5,
                               rtol=1e-4)
    _close_logits(port.logits(th), want, float(jnp.abs(want).max()))


def test_prefill_and_decode_match_reference(pair):
    """Prefill's caches (padded to S) and last logits, then each decode
    step's logits and the caches after the last one."""
    ref, params, port = pair
    tokens = _tokens(port.cfg, 1)
    h, _, _ = ref.hidden(params, jnp.asarray(tokens))
    scale = float(jnp.abs(ref.logits(params, h)).max())

    cache, last = ref.prefill(params, jnp.asarray(tokens[:, :S1]), max_seq=S)
    tcache, tlast = port.prefill(_t(tokens[:, :S1]), max_seq=S)
    _close_logits(tlast, last, scale)
    want, got = _ref_flat_cache(cache), _port_flat_cache(tcache)
    assert sorted(want) == sorted(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **STATE_TOL,
                                   err_msg=key)
    for t in range(S1, S):
        cache, lg = ref.decode(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                               t)
        tcache, tlg = port.decode(tcache, _t(tokens[:, t:t + 1]), t)
        assert tlg.shape == (B, 1, port.cfg.padded_vocab)
        _close_logits(tlg, lg, scale)
    want, got = _ref_flat_cache(cache), _port_flat_cache(tcache)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **STATE_TOL,
                                   err_msg=key)


def test_serving_steps_match_reference(pair):
    """``make_prefill_step`` then ``make_decode_step``: the same greedy
    tokens and logits as the reference's steps, fed the same tokens."""
    ref, params, port = pair
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
        assert tnxt.dtype == torch.int32
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(nxt))
        _close_logits(tlg, lg, scale)


def test_greedy_generate_matches_reference(pair):
    """The same generated tokens. Token identity is only well posed where
    the top two logits are apart, so the seed's margins are checked to
    exceed 1e-3 at every generated position (the logits agree to ~1e-6
    here), on the logits the loop itself decoded: token by token (with
    MoE a forward pass over the whole sequence routes other batches)."""
    ref, params, port = pair
    prompt, n_new = _tokens(port.cfg, 5, (B, 5)), 4
    got = steps.greedy_generate(port, _t(prompt), n_new)
    want = ref_steps.greedy_generate(ref, params, jnp.asarray(prompt), n_new)
    assert got.shape == (B, n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq = _t(np.concatenate([prompt, got.numpy().astype(np.int32)], axis=1))
    cache, logits = port.init_cache(B, seq.shape[1]), []
    for t in range(seq.shape[1] - 1):
        cache, lg = port.decode(cache, seq[:, t:t + 1], t)
        logits.append(lg)
    top2 = torch.topk(torch.cat(logits, 1)[:, prompt.shape[1] - 1:],
                      2).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port alone, as the reference's test_decode_matches_forward:
    prefill S1 tokens, decode the rest, against the full forward pass (MoE
    at the dropless capacity factor, so that dispatch does not depend on
    the batch)."""
    cfg = get_reduced_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = _t(_tokens(cfg, 3))
    full = model.logits(model.hidden(tokens)[0])
    cache, last = model.prefill(tokens[:, :S1], max_seq=S)
    errs = [float((last[:, 0] - full[:, S1 - 1]).abs().max())]
    for t in range(S1, S):
        cache, lg = model.decode(cache, tokens[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-3, errs


def test_cache_write_raises_past_the_end():
    """The reference's dynamic_update_slice clamps the start, so decoding
    past a cache prefilled without max_seq overwrites its last token; the
    port raises."""
    cfg = get_reduced_config("smollm_360m")
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = _t(_tokens(cfg, 4))
    cache, _ = model.prefill(tokens)  # no max_seq: a full cache
    with pytest.raises(IndexError, match="max_seq"):
        model.decode(cache, tokens[:, :1], S)
    buf = torch.zeros(1, 4, 1, 2)
    for pos in (-1, 4):
        with pytest.raises(IndexError):
            L.cache_write(buf, torch.ones(1, 1, 1, 2), pos)
    assert L.cache_write(buf, torch.ones(1, 1, 1, 2), 3)[0, 3].sum() == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_exactly(arch):
    ref = build_model(ref_reduced_config(arch), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(1)))
    cfg = get_reduced_config(arch)
    flat = lm_to_numpy(lm_from_numpy(cfg, params, device="cpu"))
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)}
    assert sorted(flat) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(flat[key], v, err_msg=key)
    again = lm_to_numpy(lm_from_numpy(cfg, flat, device="cpu"))
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    """``DecoderLM.init`` and the reference's init give the same parameter
    tree, and each leaf has the reference's constant values or the
    spread of its distribution (the generators differ, so values do)."""
    cfg = get_reduced_config(arch)
    ref = build_model(ref_reduced_config(arch), local_rules(),
                      compute_dtype=jnp.float32, param_dtype=jnp.float32)
    want = {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(
                ref.init(jax.random.PRNGKey(0)))}
    got = lm_to_numpy(DecoderLM(cfg, compute_dtype=torch.float32,
                                device="cpu",
                                generator=torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if w.std() == 0 or key.endswith(("w0", "A_log")):  # constants
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            # Mamba's dt bias is centred on the inverse softplus of its
            # log-uniform draw, every other drawn leaf on 0
            centre = w.mean() if key.endswith("dt_bias") else 0.0
            assert abs(g.std() / w.std() - 1) < 0.15, key
            assert abs(g.mean() - centre) < 0.2 * w.std() + 1e-3, key
