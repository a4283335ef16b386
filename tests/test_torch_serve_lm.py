"""The port's LM serving launcher and int8 KV cache against the reference,
on the CPU.

Reduced configurations in fp32, the reference's weights from
``model.init(PRNGKey(0))`` carried across by ``lm_from_numpy``, tokens
from numpy seeds, one torch thread. Bounds: ``quantize_kv`` and
``cache_read`` equal the reference's (the same fp32 operations in the same
order); logits of the int8 path within 1e-4 of the reference's largest
|logit| (its fp32 path, sums in other orders); decode with the int8 cache
against the port's own forward within the reference's int8 bound of 5e-2
(``tests/test_models.py::test_int8_kv_cache_decode``); greedy tokens
identical, on seeds whose top-two logits stay more than 1e-3 apart.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.distributed.sharding import local_rules
from repro.models import layers as RL
from repro.models.transformer import build_model
from repro_torch import obs
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.launch import serve
from repro_torch.models import DecoderLM
from repro_torch.models import layers as L
from repro_torch.weights import lm_from_numpy, lm_to_numpy

B, S, S1 = 2, 8, 4
LOGIT_REL = 1e-4
INT8_REL = 5e-2  # the reference's int8 decode-against-forward bound
MARGIN = 1e-3
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
# (arch, int8 cache): stablelm-reduced as published and with the int8
# cache its full config serves with; smollm-reduced with it (the
# reference test's arch); moonshot-reduced (MoE) with it, as its full
# config serves
INT8_CASES = [("stablelm_3b", False), ("stablelm_3b", True),
              ("smollm_360m", True), ("moonshot_v1_16b_a3b", True)]
SERVE_ARCHS = ["smollm_360m", "rwkv6_1b6", "stablelm_3b", "olmoe_1b_7b",
               "moonshot_v1_16b_a3b"]
# archs the serving loop test runs on the int8 cache of their full config
SERVE_INT8 = {"moonshot_v1_16b_a3b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the machine's cores,
    and small eager ops on a thread per core wait on each other's spinning
    pools. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, int8):
    ref_cfg, cfg = ref_reduced_config(arch), get_reduced_config(arch)
    if int8:
        ref_cfg = dataclasses.replace(ref_cfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return ref_cfg, cfg


def _pair(arch, int8=False):
    """(reference model, its params, the port's model) on shared weights."""
    ref_cfg, cfg = _configs(arch, int8)
    ref = build_model(ref_cfg, local_rules(), compute_dtype=jnp.float32,
                      param_dtype=jnp.float32)
    params = ref.init(jax.random.PRNGKey(0))
    port = lm_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    return ref, params, port


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close_logits(got, want, scale):
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= LOGIT_REL * scale, (err, scale)


# ---------------------------------------------------------------------------
# the int8 cache's layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((2, 16, 4, 32), 1.0),
                                         ((3, 5, 2, 80), 40.0),
                                         ((1, 7, 1, 64), 1e-9)])
def test_quantize_kv_equals_the_reference(shape, scale):
    """The same int8 values and fp32 scales, ties (x.5 after the divide)
    and all-zero vectors (scale clamped to 1e-8 / 127) included."""
    rng = np.random.default_rng(shape[-1])
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector
    x[0, 1, 0, :4] = [127.0, 63.5, -0.5, 2.5]  # halves after the divide
    want = RL.quantize_kv(jnp.asarray(x))
    got = L.quantize_kv(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["s"].shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_read_equals_the_reference(dtype):
    """``cache_read`` of the quantized form in fp32 and bf16, on both
    packages' quantized caches, and a plain buffer passes through."""
    x = np.random.default_rng(3).standard_normal((2, 9, 3, 80)).astype(
        np.float32)
    tq = L.quantize_kv(torch.from_numpy(x))
    jq = RL.quantize_kv(jnp.asarray(x))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = np.asarray(RL.cache_read(jq, jdt).astype(jnp.float32))
    from_jax = {n: torch.from_numpy(np.array(jq[n])) for n in ("q", "s")}
    for c in (tq, from_jax):
        got = L.cache_read(c, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
    plain = torch.from_numpy(x)
    assert L.cache_read(plain, tdt) is plain


def test_cache_write_takes_a_device_pos_and_the_int8_form():
    """A tensor pos writes in place as the int does; the int8 form writes
    the quantized token's values and scale."""
    new = torch.randn(2, 1, 3, 8, generator=torch.Generator().manual_seed(0))
    a, b = torch.zeros(2, 5, 3, 8), torch.zeros(2, 5, 3, 8)
    assert L.cache_write(a, new, 3) is a
    assert L.cache_write(b, new, torch.tensor([3], dtype=torch.int32)) is b
    assert torch.equal(a, b) and torch.equal(a[:, 3:4], new)
    c = {"q": torch.zeros(2, 5, 3, 8, dtype=torch.int8),
         "s": torch.zeros(2, 5, 3, 1)}
    L.cache_write(c, new, torch.tensor([1], dtype=torch.int32))
    qn = L.quantize_kv(new)
    assert torch.equal(c["q"][:, 1:2], qn["q"])
    assert torch.equal(c["s"][:, 1:2], qn["s"])
    assert not c["q"][:, 2:].any() and not c["s"][:, 2:].any()


@pytest.mark.parametrize("dims", [(2, 96, 4, 1, 80, 50),
                                  (2, 40, 1, 3, 32, 39),
                                  (1, 64, 2, 2, 64, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_plain_int8_equals_dequantized(dims, dtype):
    """The plain version on the int8 form equals it on ``cache_read(c,
    q.dtype)``, bit for bit, an int or a tensor pos."""
    Bn, Sn, KV, G, hd, pos = dims
    g = torch.Generator().manual_seed(hd)
    q = torch.randn(Bn, KV, G, hd, generator=g).to(dtype)
    k, v = (L.quantize_kv(torch.randn(Bn, Sn, KV, hd, generator=g))
            for _ in range(2))
    want = decode_attn(q, L.cache_read(k, dtype), L.cache_read(v, dtype),
                       pos)
    for p in (pos, torch.tensor([pos], dtype=torch.int32)):
        assert torch.equal(decode_attn(q, k, v, p), want)


# ---------------------------------------------------------------------------
# the model: device pos, int8 path against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,int8", [("smollm_360m", False),
                                       ("rwkv6_1b6", False),
                                       ("stablelm_3b", True)])
def test_tensor_pos_decode_is_host_int_decode_bit_for_bit(arch, int8):
    cfg = _configs(arch, int8)[1]
    tokens = torch.from_numpy(_tokens(cfg, 9)).long()
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    runs = []
    for as_tensor in (False, True):
        cache, _ = model.prefill(tokens[:, :S1], max_seq=S)
        logits = []
        for t in range(S1, S):
            pos = torch.tensor([t], dtype=torch.int32) if as_tensor else t
            cache, lg = model.decode(cache, tokens[:, t:t + 1], pos)
            logits.append(lg)
        flat = [t for _, t in serve._leaves(cache)]
        runs.append((torch.cat(logits, 1), flat))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def _flat_ref_cache(cache):
    return {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(cache)}


def _flat_port_cache(cache):
    flat = {}
    for block in cache:
        for path, t in serve._leaves(block):
            flat.setdefault("/".join(path), []).append(t.numpy())
    return {k: np.stack(v) for k, v in flat.items()}


@pytest.mark.parametrize("arch,int8", INT8_CASES)
def test_int8_prefill_and_decode_match_reference(arch, int8):
    """Prefill's cache (int8 values equal but where a value lies within
    rounding of a half step; scales and fp32 K/V atol 1e-5, rtol 1e-4, as
    ``tests/test_torch_lm.py``'s caches) and last logits, then each decode
    step's logits, against the reference's path."""
    ref, params, port = _pair(arch, int8)
    tokens = _tokens(port.cfg, 1)
    h, _, _ = ref.hidden(params, jnp.asarray(tokens))
    scale = float(jnp.abs(ref.logits(params, h)).max())
    cache, last = ref.prefill(params, jnp.asarray(tokens[:, :S1]), max_seq=S)
    tcache, tlast = port.prefill(torch.from_numpy(tokens[:, :S1]).long(),
                                 max_seq=S)
    _close_logits(tlast, last, scale)
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
    for t in range(S1, S):
        cache, lg = ref.decode(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                               t)
        tcache, tlg = port.decode(tcache,
                                  torch.from_numpy(tokens[:, t:t + 1]).long(),
                                  torch.tensor([t], dtype=torch.int32))
        _close_logits(tlg, lg, scale)


@pytest.mark.parametrize("arch", ["stablelm_3b", "smollm_360m"])
def test_int8_decode_matches_forward(arch):
    """The port alone, as the reference's test_int8_kv_cache_decode: the
    cache leaves are int8, padding holds zero values and zero scales, and
    decode tracks the full forward within 5e-2 of its largest |logit|."""
    cfg = _configs(arch, True)[1]
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(cfg, 3)).long()
    full = model.logits(model.hidden(tokens)[0])
    cache, last = model.prefill(tokens[:, :S1], max_seq=S)
    kv = cache[0]["sub0"]["mixer"]["k"]
    assert kv["q"].dtype == torch.int8 and kv["s"].dtype == torch.float32
    assert not kv["q"][:, S1:].any() and not kv["s"][:, S1:].any()
    errs = [float((last[:, 0] - full[:, S1 - 1]).abs().max())]
    for t in range(S1, S):
        cache, lg = model.decode(cache, tokens[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < INT8_REL, errs
    fresh = model.init_cache(B, S)[0]["sub0"]["mixer"]["v"]
    assert fresh["q"].shape == (B, S, cfg.n_kv_heads, cfg.hd)
    assert fresh["s"].shape == (B, S, cfg.n_kv_heads, 1)


def test_stablelm_config_and_weights_carry_across():
    """stablelm-3b's fields as the reference's (head dim 80, the int8
    cache, LayerNorm, qkv biases, untied head); its weights, biases
    included, round-trip key for key."""
    from repro.configs.base import get_config as ref_config

    for mine, theirs in ((get_config("stablelm_3b"),
                          ref_config("stablelm_3b")),
                         (get_reduced_config("stablelm-3b"),
                          ref_reduced_config("stablelm_3b"))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config("stablelm-3b")
    assert (full.hd, full.kv_cache_dtype, full.norm, full.qkv_bias,
            full.tie_embeddings) == (80, "int8", "layernorm", True, False)
    ref, params, port = _pair("stablelm_3b")
    params = jax.tree_util.tree_map(np.asarray, params)
    flat = lm_to_numpy(port)
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)}
    assert sorted(flat) == sorted(want)
    assert any(k.endswith("wq/b") for k in flat)
    assert any(k.endswith("norm1/bias") for k in flat)
    for key, v in want.items():
        np.testing.assert_array_equal(flat[key], v, err_msg=key)


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------
def _ref_serve(ref, params, prompts, gen):
    """The reference launcher's loop: prefill with room for P + gen, then
    ``jax.jit(model.decode)`` at every position; also the top-two margin
    of each greedy choice."""
    P = prompts.shape[1]
    cache, last = ref.prefill(params, jnp.asarray(prompts), max_seq=P + gen)
    decode = jax.jit(ref.decode)
    tok = jnp.argmax(last[:, -1, :], -1)[:, None].astype(jnp.int32)
    outs, margins = [tok], [jnp.diff(jnp.sort(last[:, -1], -1)[:, -2:])]
    for i in range(gen - 1):
        cache, logits = decode(params, cache, tok, P + i)
        margins.append(jnp.diff(jnp.sort(logits[:, -1], -1)[:, -2:]))
        tok = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
        outs.append(tok)
    return (np.asarray(jnp.concatenate(outs, axis=1)),
            float(jnp.min(jnp.stack(margins))))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_loop_tokens_equal_the_reference_loop(arch):
    ref, params, port = _pair(arch, arch in SERVE_INT8)
    prompts, gen = _tokens(port.cfg, 12, (B, 6)), 6  # margins >= 6e-3
    want, margin = _ref_serve(ref, params, prompts, gen)
    assert margin > MARGIN  # the seed's greedy choices are well posed
    res = serve.serve_tokens(port, torch.from_numpy(prompts), gen)
    assert res.graph is None and res.finite
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (B, gen)
    assert len(res.step_s) == gen - 1 and res.prefill_s > 0
    np.testing.assert_array_equal(res.tokens.numpy(), want)


def test_serve_loop_checks_the_position_on_the_host():
    port = _pair("smollm_360m")[2]
    prompts = torch.from_numpy(_tokens(port.cfg, 2, (B, 6)))
    with pytest.raises(IndexError, match="outside a cache of 7"):
        serve.serve_tokens(port, prompts, 3, max_seq=7)
    with pytest.raises(ValueError, match="CUDA"):
        serve.DecodeGraph(port, port.init_cache(B, 8), prompts[:, :1], 6)


@pytest.mark.parametrize("arch,length", [("smollm_360m", 8),
                                         ("stablelm_3b", 8),
                                         ("rwkv6_1b6", None)])
def test_decode_graph_replay_checks_the_position_on_the_host(arch, length):
    """``DecodeGraph.replay`` refuses a ``pos`` outside the K/V cache known
    at capture (the int8 form's too) before any call reaches the card; a
    cache of recurrent states only has no length to check. The object is
    built without a capture, whose CUDA graph this host cannot make."""
    cfg = _configs(arch, arch == "stablelm_3b")[1]
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert serve.cache_length(model.init_cache(B, 8), cfg) == length
    graph = object.__new__(serve.DecodeGraph)
    graph.max_seq = serve.cache_length(model.init_cache(B, 8), cfg)
    graph.pos = torch.zeros(1, dtype=torch.int32)
    if length is None:
        return
    for bad in (8, 9, -1):
        with pytest.raises(IndexError, match="outside a cache of 8"):
            graph.replay(bad)
    assert int(graph.pos) == 0  # nothing was written


def test_main_serves_on_the_cpu_and_refuses_the_multi_mesh(capsys, tmp_path,
                                                           monkeypatch):
    argv = ["--arch", "stablelm_3b", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "5", "--gen", "4"]
    monkeypatch.setenv(obs.ENV_OBS, "1")
    trace = tmp_path / "serve_trace.json"
    try:
        assert serve.main(argv + ["--trace-out", str(trace),
                                  "--profile", str(tmp_path / "prof")]) == 0
    finally:
        obs.disable()
    out = capsys.readouterr().out
    for what in ("[serve] stablelm_3b", "prefill:", "decode: p50=",
                 "sample:", "eager"):
        assert what in out
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("decode") == 3 and "prefill" in names
    assert "profiler_start" in names and "profiler_stop" in names
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))
    with pytest.raises(NotImplementedError, match="module 8"):
        serve.main(argv + ["--mesh", "multi"])


def test_profile_region_writes_a_trace_and_is_a_no_op_without_a_dir(
        tmp_path):
    with obs.profile_region(None) as started:
        assert started is False
    with obs.profile_region(str(tmp_path), host=1) as started:
        torch.ones(4).sum()
    assert started is True
    (path,) = (tmp_path / "host1").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
