"""Dry-run driver for one card (the counterpart of ``repro.launch.dryrun``).

For every (architecture x workload shape) cell: build the port's step on
meta tensors (``launch.specs.build_cell``: nothing is allocated), count
it (``launch.analysis.count_cell``: FLOPs, bytes, the peak of live
bytes) and record the roofline at the card's rates, the model FLOPs and
whether the step's peak fits the card's memory. The reference lowers and
compiles each cell for a 256- or 512-chip TPU mesh; here the mesh is the
one card, and ``--mesh multi`` raises (ROADMAP module 8). The step
counted is the eager one: no ``launch.serve.DecodeGraph``, and no CUDA
graph of ``wkv6``'s backward. Most cells do not fit one card at the
reference's global batches; their records say ``fits: false``.

Usage:
  python -m repro_torch.launch.dryrun  # every cell, a subprocess each
  python -m repro_torch.launch.dryrun --arch yi_34b --shape train_4k
  python -m repro_torch.launch.dryrun --in-process --device cpu
  python -m repro_torch.launch.dryrun --skip-existing  # resume a sweep

``--device`` is ``cuda`` by default: the record takes the card's name and
memory from ``torch.cuda``, and the driver raises where there is no card.
``--device cpu`` records the constants of the card the roofline assumes
(``analysis.CARD_NAME`` and its memory).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
_MODULE_8 = "the multi-GPU slice (ROADMAP module 8)"


def card(device: str) -> dict:
    """The card a record is for: its name and memory from ``torch.cuda``
    (``device`` "cuda", which raises where there is none), or the
    constants the roofline assumes (``device`` "cpu")."""
    from repro_torch import resolve_device
    from repro_torch.launch import analysis

    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"name": torch.cuda.get_device_name(dev),
                "memory_bytes": torch.cuda.get_device_properties(
                    dev).total_memory, "source": "torch.cuda"}
    return {"name": analysis.CARD_NAME,
            "memory_bytes": analysis.H100_MEMORY_BYTES,
            "source": "launch.analysis's constants (--device cpu)"}


def _name(arch, shape_name, mesh, variant):
    name = f"{arch}__{shape_name}__{mesh}"
    return name if variant == "base" else f"{name}__{variant}"


def run_cell(arch: str, shape_name: str, mesh: str, out_dir: Path,
             variant: str = "base", device: str = "cuda") -> dict:
    from repro_torch.configs.base import SHAPES, cell_applicable, get_config
    from repro_torch.launch import analysis
    from repro_torch.launch.specs import model_flops

    the_card = card(device)
    cfg = get_config(arch)
    if variant == "kvint8":  # the quantized KV cache
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "variant": variant, "status": "skipped", "skip_reason": why}
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{_name(arch, shape_name, mesh, variant)}.json"
    if not ok:
        path.write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.time()
    counted = analysis.count_cell(arch, shape_name, cfg=cfg, mesh=mesh)
    t_count = time.time() - t0
    ana = counted["analysis"]
    ana.pop("rows")
    memory = {k: counted[k] for k in ("param_bytes", "opt_state_bytes",
                                      "cache_bytes") if k in counted}
    terms = analysis.roofline_terms(ana)
    mf = model_flops(cfg, shape)
    dots = ana["dot_flops"]
    peak = ana["peak_live_bytes"]
    rec.update({
        "status": "ok",
        "card": the_card,
        "n_devices": 1,
        "count_s": round(t_count, 2),
        "memory": dict(memory, peak_live_bytes=peak),
        "fits": peak <= the_card["memory_bytes"],
        "analysis": ana,
        "roofline": terms,
        "roofline_rates": {"flop_per_s": analysis.H100_BF16_FLOP_PER_S,
                           "hbm_bytes_per_s": analysis.H100_HBM_BYTES_PER_S,
                           "card": analysis.CARD_NAME},
        "model_flops_global": mf,
        "counted_flops_global": dots,
        "model_to_counted_flops": (mf / dots) if dots else None,
        "param_count": {"analytic": cfg.param_count(),
                        "analytic_active": cfg.active_param_count(),
                        "model": counted["param_count"]},
        "counted_at": counted["probes"],
        "meta": dict(counted["meta"], step=(
            "eager, on meta tensors: train.steps.make_train_step or "
            "serve.steps' prefill / decode step; no CUDA graph "
            "(launch.serve.DecodeGraph, wkv6's captured backward); each "
            "kernel counted as its plain version; counted at 1 and 2 "
            "super-blocks (2 and 3 micro-batches) and extrapolated, "
            "launch.analysis.count_cell")),
    })
    path.write_text(json.dumps(rec, indent=2))
    return rec


def enumerate_cells(archs, shapes):
    from repro_torch.configs.base import SHAPES, all_arch_ids

    archs = all_arch_ids() if archs == ["all"] else archs
    shapes = list(SHAPES) if shapes == ["all"] else shapes
    for a in archs:
        for s in shapes:
            yield a, s


def _line(name, rec) -> str:
    st = rec.get("status")
    if st != "ok":
        return (f"[{st}] {name}: "
                f"{rec.get('skip_reason') or rec.get('error', '')[:300]}")
    rl = rec["roofline"]
    return (f"[ok] {name}: count={rec['count_s']}s "
            f"peak={rec['memory']['peak_live_bytes'] / 2**30:.2f}GiB "
            f"fits={rec['fits']} bottleneck={rl['bottleneck']} "
            f"(c={rl['compute_s']:.4f}s m={rl['memory_s']:.4f}s "
            f"coll={rl['collective_s']:.4f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--variant", default="base", choices=["base", "kvint8"])
    ap.add_argument("--in-process", action="store_true",
                    help="run cells in this process (default: subprocess per "
                         "cell, so that one failing cell cannot end the "
                         "sweep)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.mesh == "multi":
        raise NotImplementedError(f"--mesh multi: multi-pod meshes come "
                                  f"with {_MODULE_8}; the port's dry-run "
                                  f"runs on one card")
    card(args.device)  # no card where one is asked for: raise here
    torch.set_num_threads(1)  # shapes only: one thread does it
    out_dir = Path(args.out)

    cells = list(enumerate_cells(args.arch, args.shape))
    single = len(cells) == 1
    failures = 0
    records = []
    for arch, shape in cells:
        name = _name(arch, shape, args.mesh, args.variant)
        path = out_dir / f"{name}.json"
        if args.skip_existing and path.exists():
            st = json.loads(path.read_text()).get("status")
            if st in ("ok", "skipped"):
                print(f"[skip-existing] {name}: {st}", flush=True)
                continue
        base = {"arch": arch, "shape": shape, "mesh": args.mesh,
                "variant": args.variant}
        if args.in_process or single:
            try:
                rec = run_cell(arch, shape, args.mesh, out_dir, args.variant,
                               args.device)
            except Exception as e:  # record the failure, keep sweeping
                rec = dict(base, status="error",
                           error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
                out_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(rec, indent=2))
        else:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", args.mesh,
                   "--out", str(out_dir), "--variant", args.variant,
                   "--device", args.device]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                if r.returncode != 0 and not path.exists():
                    rec = dict(base, status="error", error=r.stderr[-4000:])
                    out_dir.mkdir(parents=True, exist_ok=True)
                    path.write_text(json.dumps(rec, indent=2))
            except subprocess.TimeoutExpired:
                rec = dict(base, status="timeout", timeout_s=args.timeout)
                out_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(rec, indent=2))
            rec = json.loads(path.read_text()) if path.exists() else rec
        failures += rec.get("status") in ("error", "timeout")
        records.append(rec)
        print(_line(name, rec), flush=True)
    if failures:
        print(f"{failures} cell(s) failed", flush=True)
        sys.exit(1)
    return records


if __name__ == "__main__":
    main()
