"""Batched LM serving launcher (port of ``repro.launch.serve``): prefill
with a KV cache, then greedy decode, the decode step captured once as a
CUDA graph and replayed for every position.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \\
        --mesh single --requests 16 --prompt-len 1024 --gen 65
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-3.2-vision-90b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-large-v2 --reduced --device cpu

The reference jits ``model.decode`` once and calls it for every ``pos``;
here :class:`DecodeGraph` captures one step with the token and ``pos`` in
static device buffers (``pos`` a one-element int32 tensor the step reads
on the card), the K/V cache written in place and RWKV's states copied back
into their buffers inside the step, and the argmax token left in the
token buffer for the next replay. A failed capture raises: there is no
eager fallback on the card. On the CPU the same loop runs eagerly. A
VLM's image tokens (``extras["context"]``, drawn as the reference draws
them) go into the prefill only: its XATTN layers' caches hold them for
every step after. So do an encoder-decoder's frames (``extras
["frames"]``, ``prompt-len + gen`` of them, as the reference's): the
prefill encodes them and writes each decoder layer's cross K/V once; a
Mamba layer's states are replaced each step as RWKV's are.

``--mesh local`` serves in fp32, ``single`` in bf16 on the one card;
``multi`` (the reference's multi-pod mesh) waits for ROADMAP module 8.
Observability as in the reference: ``--profile DIR`` wraps the serving
region in :func:`repro_torch.obs.profile_region` (a ``torch.profiler``
trace); ``REPRO_OBS=1`` turns on the span plane, and ``--trace-out``
writes its Chrome trace (prefill and per-step decode spans).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device, synchronize
from repro_torch.configs.base import ATTN

WARMUP_STEPS = 2  # eager steps on a side stream before the capture


def _leaves(tree, path=()):
    """(path, tensor) of every leaf of a cache (lists and dicts)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _is_state(path) -> bool:
    """A recurrent state (replaced each step), not a K/V buffer (written
    in place)."""
    return "k" not in path and "v" not in path


def cache_length(cache, cfg) -> Optional[int]:
    """Positions the self-attention K/V buffers of ``cache`` (a model of
    ``cfg``'s) hold, the int8 form's too, or None where its block pattern
    has no self-attention (recurrent states only). An XATTN layer's
    buffers hold the context's positions, which no step writes."""
    for i, (mixer, _ffn) in enumerate(cfg.block_pattern):
        if mixer == ATTN:
            k = cache[0][f"sub{i}"]["mixer"]["k"]
            return (k["q"] if isinstance(k, dict) else k).shape[1]
    return None


def _kernel_launches() -> collections.Counter:
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.wkv6 import kernel as wk

    return collections.Counter({**dk.LAUNCHES, **wk.LAUNCHES})


class DecodeGraph:
    """One greedy decode step of ``model`` captured as a CUDA graph.

    Static buffers: ``token`` (B, 1) int32, the step's input and, after a
    replay, its argmax output; ``pos``, a one-element int32 tensor;
    ``cache``, whose K/V buffers the step writes in place and whose states
    it copies back into their own buffers (cloned here from the prefill's);
    ``logits`` (B, 1, V), and ``finite``, whether every replayed step's
    logits were finite. The step is warmed up on a side stream (the
    recurrent states and the token restored after it), then captured;
    ``launches`` counts the port's kernel launches the capture recorded,
    which every replay repeats. ``max_seq`` is the K/V buffers' length
    (None for recurrent states only), against which :meth:`replay`
    checks its ``pos`` on the host."""

    def __init__(self, model, cache, token, pos: int):
        dev = token.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
        self.model = model
        self.max_seq = cache_length(cache, model.cfg)
        self.cache = _own_states(cache)
        self.token = token.to(torch.int32).reshape(-1, 1).clone()
        self.pos = torch.full((1,), pos, dtype=torch.int32, device=dev)
        self.finite = torch.ones((), dtype=torch.bool, device=dev)
        saved = [t.clone() for p, t in _leaves(self.cache) if _is_state(p)]
        saved_token = self.token.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):  # step 0 rewrites K/V at pos
                self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        states = [t for p, t in _leaves(self.cache) if _is_state(p)]
        for t, s in zip(states, saved):
            t.copy_(s)
        self.token.copy_(saved_token)
        self.finite.fill_(True)
        self.graph = torch.cuda.CUDAGraph()
        before = _kernel_launches()
        with torch.cuda.graph(self.graph):
            self.logits = self._step()
        self.launches = dict(_kernel_launches() - before)

    def _step(self):
        new_cache, logits = self.model.decode(self.cache, self.token,
                                              self.pos)
        for (_, old), (_, new) in zip(_leaves(self.cache),
                                      _leaves(new_cache)):
            if new is not old:
                old.copy_(new)
        self.finite &= torch.isfinite(logits).all()
        self.token.copy_(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
        return logits

    def replay(self, pos: int):
        """The step at ``pos``: afterwards ``token`` holds its argmax and
        ``logits`` its logits. A ``pos`` outside the K/V cache raises
        ``IndexError`` before anything reaches the card (the captured step
        reads ``pos`` there unchecked)."""
        pos = int(pos)
        if self.max_seq is not None and not 0 <= pos < self.max_seq:
            raise IndexError(f"decode at pos {pos} outside a cache of "
                             f"{self.max_seq} tokens")
        self.pos.fill_(pos)
        self.graph.replay()
        return self.token


def _own_states(cache, path=()):
    """The cache with each recurrent state cloned into a buffer of its
    own (the prefill's are views into its activations); K/V buffers as
    they are."""
    if isinstance(cache, torch.Tensor):
        return cache.clone() if _is_state(path) else cache
    if isinstance(cache, dict):
        return {k: _own_states(v, path + (k,)) for k, v in cache.items()}
    return [_own_states(v, path + (i,)) for i, v in enumerate(cache)]


@dataclasses.dataclass
class ServeResult:
    """``tokens`` (B, gen) int32: the prefill's argmax, then each decode
    step's; ``prefill_s`` and ``step_s`` (each decode step) on the host
    clock, each ending in a synchronize; ``finite``: every logit of the
    prefill and the steps; ``graph``: the captured step (None when eager),
    with its ``launches``; ``capture_s``: its warm-up and capture."""
    tokens: torch.Tensor
    prefill_s: float
    step_s: List[float]
    finite: bool
    graph: Optional[DecodeGraph] = None
    capture_s: float = 0.0


def serve_tokens(model, prompts, gen: int, max_seq: Optional[int] = None,
                 graph: Optional[bool] = None, tracer=None,
                 extras=None) -> ServeResult:
    """Prefill ``prompts`` (B, P) with room for ``max_seq`` tokens (default
    P + gen), and ``extras`` (a VLM's ``{"context": (B, n_frontend_tokens,
    d)}``, an encoder-decoder's ``{"frames": (B, enc_len, d)}``), then ``gen - 1`` greedy decode steps at positions P, P + 1,
    ... . ``graph`` (default: on a CUDA model) captures the step once and
    replays it; otherwise each step runs eagerly with the position as an
    int (``serve.steps.make_decode_step``). Each position is checked
    against the cache on the host before its step."""
    from repro_torch.serve.steps import make_decode_step

    dev = model.device
    graph = dev.type == "cuda" if graph is None else graph
    B, P = prompts.shape
    max_seq = P + gen if max_seq is None else max_seq
    synchronize(dev)
    t0 = time.perf_counter()
    cache, last = model.prefill(prompts, extras, max_seq=max_seq)
    finite = torch.isfinite(last).all()
    tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    if tracer is not None:
        tracer.complete("prefill", "server", t0, t_prefill, batch=B,
                        prompt_len=P)
    outs, lat, step, capture_s = [tok], [], None, 0.0
    if gen > 1 and graph:
        t1 = time.perf_counter()
        step = DecodeGraph(model, cache, tok, P)
        synchronize(dev)
        capture_s = time.perf_counter() - t1
    decode = make_decode_step(model, model.cfg)
    for i in range(gen - 1):
        pos = P + i
        if pos >= max_seq:
            raise IndexError(f"decode at pos {pos} outside a cache of "
                             f"{max_seq} tokens")
        t0 = time.perf_counter()
        if step is not None:
            tok = step.replay(pos)[:, 0]
        else:
            cache, tok, logits = decode(cache, tok[:, None], pos)
            finite &= torch.isfinite(logits).all()
        synchronize(dev)
        lat.append(time.perf_counter() - t0)
        if tracer is not None:
            tracer.complete("decode", "server", t0, lat[-1], step=i)
        outs.append(tok.clone())
    if step is not None:
        finite &= step.finite
    return ServeResult(torch.stack(outs, dim=1), t_prefill, lat,
                       bool(finite), step, capture_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace under DIR")
    ap.add_argument("--trace-out", default="serve_trace.json",
                    help="Chrome trace output path (with REPRO_OBS=1)")
    args = ap.parse_args(argv)
    if args.mesh == "multi":
        raise NotImplementedError(
            "--mesh multi: the multi-pod mesh comes with the multi-GPU "
            "slice (ROADMAP module 8); the port serves on one card")
    obs.enable_from_env()

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import DecoderLM, EncDecLM

    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    dtype = torch.float32 if args.mesh == "local" else torch.bfloat16
    model = (EncDecLM if cfg.enc_dec else DecoderLM)(
        cfg, compute_dtype=dtype, param_dtype=dtype, device=dev,
        generator=torch.Generator(dev).manual_seed(0))

    B, P, G = args.requests, args.prompt_len, args.gen
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                               .astype(np.int32)).to(dev)
    extras = {}
    if cfg.cross_attn_every:  # the frontend stub's image tokens
        extras["context"] = torch.from_numpy(rng.normal(
            0, 0.3, (B, cfg.n_frontend_tokens, cfg.d_model))).to(
                device=dev, dtype=dtype)
    if cfg.enc_dec:  # the frontend stub's audio frames
        extras["frames"] = torch.from_numpy(rng.normal(
            0, 0.3, (B, P + G, cfg.d_model))).to(device=dev, dtype=dtype)

    tracer = obs.get_tracer()
    with obs.profile_region(args.profile):
        res = serve_tokens(model, prompts, G, tracer=tracer, extras=extras)
    if tracer is not None:
        tracer.write(args.trace_out)
        print(f"[obs] Chrome trace -> {args.trace_out}")
    lat = np.asarray(res.step_s[1:] if len(res.step_s) > 1 else res.step_s)
    mode = (f"one CUDA graph, captured in {res.capture_s * 1000:.1f} ms"
            if res.graph is not None else "eager")
    print(f"[serve] {args.arch}: batch={B} prompt={P} gen={G} "
          f"({dtype}, {dev}, decode {mode})")
    print(f"  prefill: {res.prefill_s*1000:.1f} ms "
          f"({B*P/max(res.prefill_s,1e-9):.0f} tok/s)")
    if lat.size:
        print(f"  decode: p50={np.percentile(lat,50)*1000:.1f} ms "
              f"p99={np.percentile(lat,99)*1000:.1f} ms "
              f"({B/np.median(lat):.0f} tok/s)")
    print(f"  sample: {res.tokens[0][:12].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
