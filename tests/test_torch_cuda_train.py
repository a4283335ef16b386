"""LM training on a card: the ``wkv6`` autograd Function and one fp32
train step on the card against the CPU.

This file imports no JAX, so it runs on a CUDA host without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_train.py

Elsewhere every test skips. Bounds: the Function's output within the
kernel's bound against the chunked form (atol 2e-4, rtol 1e-3); its
gradients (replayed from the backward's CUDA graph but at the call that
captures it) are autograd of the fp32 chunked form on the same widened
values, r's, k's and v's rounded once to bf16 (rtol 2^-8), the fp32 ones
within 1e-6 of their largest; the card's train step against the CPU's:
loss within 1e-5 relative, every gradient within 1e-4 of its leaf's
largest (fp32 sums in other orders), updated parameters within 1e-6
where |g| is at least 1e-3 of its leaf's largest and within twice the
rate elsewhere (AdamW's first step is about lr * sign(g)).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6 import ops as wo
from repro_torch.kernels.wkv6.ref import wkv_chunked
from repro_torch.models import DecoderLM
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.train import steps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wkv_inputs(cuda, ld_low, ld_high, B=2, S=256, H=4, hd=64, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def n(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=cuda)

    r, k, v = (n(B, S, H, hd, scale=0.5).bfloat16() for _ in range(3))
    ld = ld_low + (ld_high - ld_low) * torch.rand(
        (B, S, H, hd), generator=gen, device=cuda)
    xs = [r, k, v, ld, n(H, hd, scale=0.3), n(B, H, hd, hd, scale=0.2)]
    cot = (n(B, S, H, hd), n(B, H, hd, hd))
    return xs, cot


@pytest.mark.parametrize("S", [256, 1000])
def test_wkv6_function_gradients_match_the_fp32_chunked_form(cuda, S):
    """The first call captures the backward's CUDA graph, the second
    replays it on other inputs: both against the eager fp32 form."""
    for seed in (0, 1):
        xs, cot = _wkv_inputs(cuda, -1.0, -0.1, S=S, seed=seed)
        ins = [x.clone().requires_grad_() for x in xs]
        launches, backwards = wk.LAUNCHES["wkv6"], wo.BACKWARDS["wkv6"]
        outs = wo.wkv6(*ins)
        got = torch.autograd.grad(outs, ins, cot)
        assert wk.LAUNCHES["wkv6"] == launches + 1
        assert wo.BACKWARDS["wkv6"] == backwards + 1
        ref_ins = [x.float().clone().requires_grad_() for x in xs]
        want_out = wkv_chunked(*ref_ins)
        want = torch.autograd.grad(want_out, ref_ins, cot)
        torch.testing.assert_close(outs[0].detach(), want_out[0].detach(),
                                   atol=2e-4, rtol=1e-3)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == xs[i].dtype
            scale = float(w.abs().max())
            rtol = 2.0 ** -8 if i < 3 else 1e-6
            torch.testing.assert_close(g.float(), w, atol=1e-6 * scale,
                                       rtol=rtol)


def test_wkv6_backward_graph_is_captured_once_per_shape(cuda):
    """Calls at one set of shapes capture one graph and replay it; each
    returns gradients of its own (copies, not the graph's buffers)."""
    xs, cot = _wkv_inputs(cuda, -1.0, -0.1, S=64, seed=3)
    captured = wo.BACKWARDS["captured"]
    got = []
    for scale in (1.0, 2.0, 1.0):
        ins = [(x * scale).requires_grad_() for x in xs]
        got.append(torch.autograd.grad(wo.wkv6(*ins)[0], ins[:4], cot[0]))
    assert wo.BACKWARDS["captured"] == captured + 1
    for a, b in zip(got[0], got[2]):
        assert torch.equal(a, b)
    assert not torch.equal(got[0][0], got[1][0])


def test_wkv6_function_gradients_finite_for_fast_decays(cuda):
    xs, cot = _wkv_inputs(cuda, -3.0, -3.0)
    ins = [x.clone().requires_grad_() for x in xs]
    got = torch.autograd.grad(wo.wkv6(*ins), ins, cot)
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_wkv6_without_gradients_takes_no_function(cuda):
    xs, _ = _wkv_inputs(cuda, -1.0, -0.1)
    backwards = wo.BACKWARDS["wkv6"]
    with torch.no_grad():
        o, s = wo.wkv6(*[x.clone().requires_grad_() for x in xs])
    assert o.grad_fn is None and s.grad_fn is None
    o, s = wo.wkv6(*xs)  # no input needs a gradient
    assert o.grad_fn is None
    assert wo.BACKWARDS["wkv6"] == backwards


@pytest.mark.parametrize("arch", ["smollm_360m", "rwkv6_1b6"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    cfg = get_reduced_config(arch)
    cpu = DecoderLM(cfg, torch.float32, torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    card = DecoderLM(cfg, torch.float32, torch.float32, device=cuda,
                     init=False)
    card.load_state_dict(cpu.state_dict())
    batch = batch_at(DataConfig(cfg.vocab_size, 64, 4), 0)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        opt = AdamW(schedule=warmup_cosine(3e-4, 0, 100))
        state = steps.init_train_state(model, opt, dev)
        loss, _, grads = steps.make_grad_fn(model, cfg)(
            state["params"], {k: torch.from_numpy(v).to(dev)
                              for k, v in batch.items()})
        state, metrics = steps.make_train_step(model, cfg, opt)(state, batch)
        assert float(metrics["skipped"]) == 0.0
        out[dev] = (float(loss), {n: g.cpu() for n, g in grads.items()},
                    {n: p.detach().cpu() for n, p in
                     state["params"].items()}, float(metrics["lr"]))
    (l_cpu, g_cpu, p_cpu, lr), (l_card, g_card, p_card, _) = (out["cpu"],
                                                              out["cuda"])
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    for n, g in g_cpu.items():
        scale = float(g.abs().max())
        assert float((g_card[n] - g).abs().max()) <= 1e-4 * scale, n
        err = (p_card[n] - p_cpu[n]).abs()
        firm = g.abs() >= 1e-3 * g.abs().max()
        if firm.any():
            assert float(err[firm].max()) <= 1e-6, n
        assert float(err.max()) <= 2 * lr + 1e-6, n
    assert np.isfinite(l_card)
