"""Public entry point of the RWKV6 WKV recurrence (the time-mix hot loop).

A CUDA tensor launches the hand-written kernel (``kernel.py``), which
either runs or raises; a CPU tensor takes the reference model's chunked
form (``ref.wkv_chunked``). Any length runs as it is, one token included:
nothing is padded.

Training: where autograd records the call on the card (grad mode on and
an input requiring a gradient), it goes through :class:`WKV6Function`,
whose forward is the same kernel launch and whose backward recomputes
``ref.wkv_chunked`` in fp32 and differentiates it. The reference trains
by differentiating exactly that chunked form (its models never reach
``wkv6_pallas``, which has no VJP), so the backward is no kernel of its
own. That recompute and its gradients are ~3,000 small kernels at
rwkv6-1.6b's training shape (32 chunks of 32 tokens), which eager
PyTorch launches in ~120-180 ms of host time against ~17 ms of device
time; so on the card they are captured once per set of shapes as a CUDA
graph (:class:`_GraphedGrads`) and replayed: the same kernels on copies
of the inputs. :data:`BACKWARDS` counts the Function's backward passes
("wkv6") and the graphs captured ("captured"), so that a run can show
that the chunked form ran there and nowhere else.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv_chunked

#: backward passes of :class:`WKV6Function` ("wkv6") and CUDA graphs of
#: its backward captured ("captured")
BACKWARDS: collections.Counter = collections.Counter()
GRAPH_CACHE_SIZE = 4  # captured backward graphs kept, the newest
_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()


def _launch(r, k, v, log_decay, u, s0):
    return wkv6_cuda(*(t.contiguous() for t in (r, k, v, log_decay,
                                                u.float(), s0.float())))


def _chunked_grads(inputs, cots, need):
    """Gradients of ``wkv_chunked`` at ``inputs`` (r, k, v, log_decay, u,
    s0) against the cotangents ``cots`` of (o, state) (None where that
    output has none): one per input, None where ``need`` is False."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
        pairs = [(o, g) for o, g in zip(wkv_chunked(*xs), cots)
                 if g is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], [x for x, n in zip(xs, need) if n],
            [g for _, g in pairs], allow_unused=True))
    return [next(got) if n else None for n in need]


class _GraphedGrads:
    """:func:`_chunked_grads` for one set of shapes, types and needs,
    captured as a CUDA graph: two eager runs on a side stream warm it up,
    one more is captured, and each call copies its tensors into the
    graph's inputs, replays it on the current stream and returns copies of
    its gradients (the next replay overwrites them)."""

    def __init__(self, inputs, cots, need):
        self.inputs = [t.detach().clone() for t in inputs]
        self.cots = [None if c is None else c.clone() for c in cots]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                _chunked_grads(self.inputs, self.cots, need)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.grads = _chunked_grads(self.inputs, self.cots, need)
        BACKWARDS["captured"] += 1

    def __call__(self, inputs, cots):
        for dst, src in zip(self.inputs + self.cots, list(inputs) + cots):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        return [None if g is None else g.clone() for g in self.grads]


def _graphed_grads(inputs, cots, need):
    key = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs) + (
        tuple(need), tuple(c is None for c in cots))
    graphed = _GRAPHS.pop(key, None) or _GraphedGrads(inputs, cots, need)
    _GRAPHS[key] = graphed  # the newest last
    while len(_GRAPHS) > GRAPH_CACHE_SIZE:
        _GRAPHS.popitem(last=False)
    return graphed(inputs, cots)


class WKV6Function(torch.autograd.Function):
    """The kernel's forward under autograd. It saves its inputs; the
    backward recomputes the chunked form from them under grad mode
    (replayed from a CUDA graph on the card) and returns its gradients,
    each in its input's type."""

    @staticmethod
    def forward(ctx, r, k, v, log_decay, u, s0):
        ctx.save_for_backward(r, k, v, log_decay, u, s0)
        ctx.set_materialize_grads(False)
        return _launch(r, k, v, log_decay, u, s0)

    @staticmethod
    def backward(ctx, d_o, d_state):
        BACKWARDS["wkv6"] += 1
        inputs = ctx.saved_tensors
        grads_of = _graphed_grads if inputs[0].is_cuda else _chunked_grads
        grads = grads_of(inputs, [d_o, d_state], ctx.needs_input_grad)
        return tuple(None if g is None else g.to(x.dtype)
                     for g, x in zip(grads, inputs))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_decay: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, v (B, S, H, hd) (bf16 or fp32), log_decay (B, S, H, hd) fp32,
    u (H, hd), s0 (B, H, hd, hd) -> (o (B, S, H, hd), state (B, H, hd,
    hd)), both fp32."""
    xs = (r, k, v, log_decay, u, s0)
    if not on_cuda(r, "wkv6"):
        return wkv_chunked(*xs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        return WKV6Function.apply(*xs)
    return _launch(*xs)
