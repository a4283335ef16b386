"""LM training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --reduced --steps 200 --mesh local --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1b6 \\
        --mesh single --steps 100 --batch 8 --seq 1024

Fault tolerance in the loop, as the reference's:
- auto-resume from the newest checkpoint (``--resume auto``)
- async atomic checkpoint every ``--ckpt-every`` steps and on
  SIGTERM/SIGINT (preemption-style shutdown saves before exiting)
- NaN/inf skip-step guard inside the step (metrics report ``skipped``)
- per-step wall-time watchdog: steps slower than ``watchdog_factor`` x the
  trailing median are logged as straggler events
- deterministic data: batch(step) is pure, so restart needs no replay

``--mesh local`` computes in fp32, ``single`` in bf16 on the one card
(parameters and moments fp32 either way, the moments in the config's
``opt_moment_dtype``); ``multi`` and ``--compression`` come with the
multi-GPU slice (ROADMAP module 8). ``--device`` is ``cuda`` by default,
which raises where there is none. Weights are drawn from a generator
seeded with 0 on the device.
"""
from __future__ import annotations

import argparse
import signal
import statistics
import sys
import time

import torch

_MODULE_8 = "the multi-GPU slice (ROADMAP module 8)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--compression", default=None,
                    choices=[None, "int8", "bf16"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.mesh == "multi":
        raise NotImplementedError(f"--mesh multi: the multi-pod mesh comes "
                                  f"with {_MODULE_8}; the port trains on "
                                  f"one card")
    if args.compression:
        raise NotImplementedError(f"--compression {args.compression}: the "
                                  f"cross-pod gradient reduction comes "
                                  f"with {_MODULE_8}")

    from repro_torch import resolve_device, synchronize
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.tokens import DataConfig, PrefetchingLoader
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.steps import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    model = (EncDecLM if cfg.enc_dec else DecoderLM)(
        cfg, compute_dtype=torch.float32 if args.mesh == "local"
        else torch.bfloat16, param_dtype=torch.float32, device=dev,
        generator=torch.Generator(dev).manual_seed(0))
    opt = AdamW(schedule=warmup_cosine(args.lr, 20, args.steps),
                moment_dtype=getattr(torch, cfg.opt_moment_dtype))

    ckpt_dir = args.ckpt_dir or f"experiments/ckpt/{args.arch}"
    mgr = CheckpointManager(ckpt_dir, keep=3)

    state = init_train_state(model, opt, dev)
    start_step = 0
    if args.resume == "auto" and mgr.latest_step() is not None:
        restored = mgr.restore(state)
        with torch.no_grad():  # into the model's own parameters
            for name, p in state["params"].items():
                p.copy_(restored["params"][name])
        state["opt"], state["step"] = restored["opt"], restored["step"]
        start_step = int(state["step"])
        print(f"[resume] restored step {start_step} from {ckpt_dir}",
              flush=True)

    step_fn = make_train_step(model, cfg, opt, grad_accum=1)
    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch)
    loader = PrefetchingLoader(dcfg, start_step=start_step)

    stop = {"now": False}

    def on_signal(sig, frame):
        print(f"[signal] {sig}: checkpoint + exit", flush=True)
        stop["now"] = True

    previous = {s: signal.signal(s, on_signal)
                for s in (signal.SIGTERM, signal.SIGINT)}
    times = []
    metrics = {}
    try:
        for step, batch in loader:
            if step >= args.steps or stop["now"]:
                break
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            synchronize(dev)
            dt = time.perf_counter() - t0
            times.append(dt)
            if len(times) > 20:
                med = statistics.median(times[-20:])
                if dt > args.watchdog_factor * med and len(times) > 5:
                    print(f"[straggler] step {step}: {dt:.3f}s vs median "
                          f"{med:.3f}s", flush=True)
            if step % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {step}: loss={m['nll']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                      f"{dt*1000:.0f}ms", flush=True)
            if args.ckpt_every and step > 0 and step % args.ckpt_every == 0:
                mgr.save(step + 1, state)
    finally:
        loader.close()
        for s, handler in previous.items():
            signal.signal(s, handler)
    final_step = int(state["step"])
    mgr.save(final_step, state)
    mgr.wait()
    if metrics:
        m = {k: float(v) for k, v in metrics.items()}
        print(f"[done] step {final_step} loss={m.get('nll', float('nan')):.4f} "
              f"ckpt={ckpt_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
