"""Per-cell roofline contributors (the counterpart of
``repro.launch.contrib``).

    PYTHONPATH=src python -m repro_torch.launch.contrib --arch yi_34b \\
        --shape train_4k --top 12 --device cpu

Prints the top HBM-byte, collective and FLOP contributors of one cell's
count (``launch.analysis.count_cell`` on meta tensors), by aten op and
the module it runs in (every block as ``blocks.*``; a backward op's
module carries ``(backward)``), with its calls: what a profiler would rank, from the eager step's ops. On one
card there are no collectives.
"""
from __future__ import annotations

import argparse
import sys

from torch.utils.flop_counter import flop_registry

_DOTS = {str(op) for op in flop_registry}  # the ops with a FLOP formula


def top_contributors(analysis: dict, top: int = 12):
    """Print the ``top`` rows of ``analysis["rows"]`` ((aten op, module)
    -> (FLOPs, bytes, calls)) by bytes and by FLOPs, and the collectives
    (none on one card)."""
    rows = analysis["rows"]
    byte_rows = sorted(((b, c, op, mod) for (op, mod), (_, b, c)
                        in rows.items()), reverse=True)
    flop_rows = sorted(((f, c, op, mod) for (op, mod), (f, _, c)
                        in rows.items() if op in _DOTS), reverse=True)
    for title, found, unit in (("HBM bytes", byte_rows, "GB"),
                               ("collectives", [], "GB"),
                               ("dot FLOPs", flop_rows, "GF")):
        total = sum(r[0] for r in found)
        print(f"\n== top {title} (total {total / 1e9:.1f} {unit}) ==")
        for val, calls, op, mod in found[:top]:
            print(f"  {val / 1e9:9.1f} {unit} x{calls:8d} {op:28s} "
                  f"{mod[-80:]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch import analysis
    from repro_torch.launch.dryrun import card

    card(args.device)
    counted = analysis.count_cell(args.arch, args.shape, mesh=args.mesh)
    top_contributors(counted["analysis"], args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
