"""Time ``decode_attn`` of two checkouts of this repository on one card,
in turns (A, B, B, A), at the shapes ``chip_smoke.py`` times it. On a
CUDA host:

    python3 tools/decode_attn_ab.py OTHER_CHECKOUT [--row TAG].. [--rounds N]

A is OTHER_CHECKOUT (for instance the parent commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists), B this checkout.
``--row`` times only the rows named (default: every row of ``ROWS``),
``--rounds`` runs the four turns N times over (default 1). Each turn is a
process of its own that imports the port from its checkout's ``src/``
and builds its library there first; every row is checked against that
checkout's plain version (atol 1e-5, rtol 1e-4) and timed as
``chip_smoke.py`` times it: the device time of a CUDA graph of 10 calls
with a 128 MB read before each, less that read alone, median of 20. Then
it compares the SASS (``cuobjdump -sass``) of each
``decode_attn_kernel`` instantiation in the two libraries and names those
that differ. Prints one line per turn and row, then a JSON object with
the medians and all times of both sides, the instantiations whose SASS
differs and the card's name and power limit.
"""
from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# (row, B, S, KV, G, hd, pos, q's type, int8 cache): chip_smoke.py's
# decode_attn rows (decode_32k timed alone, without its plain version)
ROWS = (("path,bf16", 16, 2048, 5, 3, 64, 1087, "bf16", False),
        ("path,fp32", 16, 2048, 5, 3, 64, 1087, "fp32", False),
        ("decode_32k,bf16", 128, 32768, 5, 3, 64, 32767, "bf16", False),
        ("stablelm,bf16", 16, 2048, 32, 1, 80, 1087, "bf16", False),
        ("stablelm,fp32", 16, 2048, 32, 1, 80, 1087, "fp32", False),
        ("stablelm,int8", 16, 2048, 32, 1, 80, 1087, "bf16", True),
        ("smollm,int8", 16, 2048, 5, 3, 64, 1087, "bf16", True),
        ("olmoe,bf16", 16, 2048, 16, 1, 128, 1087, "bf16", False),
        ("moonshot,int8", 16, 2048, 16, 1, 128, 1087, "bf16", True),
        ("jamba,bf16", 16, 2048, 8, 8, 128, 1087, "bf16", False),
        ("llama-vision,int8", 16, 2048, 8, 8, 128, 1087, "bf16", True),
        ("llama-vision-xattn,int8", 16, 6404, 8, 8, 128, 6403, "bf16",
         True),
        ("seamless,bf16", 16, 2048, 16, 1, 64, 1087, "bf16", False),
        ("seamless-xattn,bf16", 16, 1024, 16, 1, 64, 1023, "bf16", False))
L2_FLUSH_BYTES = 128 << 20
TOL = (1e-5, 1e-4)


def _turn(checkout: Path, tags) -> dict:
    """This process's rows (those of ``tags``), timed with ``checkout``'s
    port, and the path of its library."""
    import torch

    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.models.layers import quantize_kv

    build.build(["decode_attn"])
    scratch = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")

    def device_ms(fn, iters=20, reps=10):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        times = []
        for _ in range(iters):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    def cold_ms(fn):
        def both():
            scratch.sum()
            fn()
        return device_ms(both) - device_ms(scratch.sum)

    out = {}
    for tag, B, S, KV, G, hd, pos, qtype, int8 in ROWS:
        if tag not in tags:
            continue
        dtype = torch.bfloat16 if qtype == "bf16" else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(S + pos + hd)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((B, KV, G, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        q = q.to(dtype)
        k, v = ((quantize_kv(k), quantize_kv(v)) if int8
                else (k.to(dtype), v.to(dtype)))
        got = decode_attn_cuda(q, k, v, pos)
        if B * S <= 16 * 6404:  # not decode_32k: 21 GB of plain copies
            want = decode_attn_ref(q, k, v, pos)
            excess = float(((got - want).abs()
                            - TOL[1] * want.abs()).max())
            if not bool(torch.isfinite(got).all()) or excess > TOL[0]:
                raise AssertionError(f"{checkout}: decode_attn[{tag}] "
                                     f"disagrees with its plain version")
        out[tag] = cold_ms(lambda: decode_attn_cuda(q, k, v, pos))
        del q, k, v, got
        torch.cuda.empty_cache()
    return {"ms": out, "library": str(build.library_path("decode_attn"))}


def sass_by_kernel(library: str) -> dict:
    """{``<T, E, HD, G>``: its SASS instructions} of the decode_attn_kernel
    instantiations in ``library`` (the mangled names carry a hash of the
    source file's path, from the anonymous namespace): each instruction's
    text at its offset, without the encodings and the listing around them,
    and with the listing's labels (numbered across the whole library)
    numbered within the function."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if "decode_attn_kernel" not in name:
            continue
        labels = {}

        def local(m):
            return f"L{labels.setdefault(m.group(0), len(labels))}"

        out[_label(name)] = [
            (at, re.sub(r"\.L_x_\d+|__internal_\d+", local, ins))
            for at, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*;)",
                                      part)]
    return out


def _label(fn):
    """``<T, E, HD, G>`` of a mangled decode_attn_kernel name."""
    m = re.search(r"decode_attn_kernelI(13__nv_bfloat16|f)(S1_|f|a)Li(\d+)E"
                  r"Li(\d+)E", fn)
    q = "bf16" if m.group(1) != "f" else "fp32"
    cache = "int8_t" if m.group(2) == "a" else q
    return f"<{q}, {cache}, {m.group(3)}, {m.group(4)}>"


def main(argv):
    if len(argv) == 4 and argv[1] == "--turn":
        print(json.dumps(_turn(Path(argv[2]), json.loads(argv[3]))))
        return
    args, tags, rounds = [], [], "1"
    rest = iter(argv[1:])
    for a in rest:
        if a == "--row":
            tags.append(next(rest, ""))
        elif a == "--rounds":
            rounds = next(rest, "")
        else:
            args.append(a)
    tags = tags or [r[0] for r in ROWS]
    if (len(args) != 1 or not rounds.isdigit() or int(rounds) < 1
            or not set(tags) <= {r[0] for r in ROWS}):
        sys.exit(__doc__)
    rounds = int(rounds)
    import torch

    if not torch.cuda.is_available():
        sys.exit("decode_attn_ab: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sides = {"A": Path(args[0]).resolve(),
             "B": Path(__file__).resolve().parents[1]}
    times, libraries = {"A": {}, "B": {}}, {}
    for side in ("A", "B", "B", "A") * rounds:
        run = subprocess.run([sys.executable, __file__, "--turn",
                              str(sides[side]), json.dumps(tags)],
                             capture_output=True, text=True, timeout=1200)
        if run.returncode:
            sys.exit(f"turn {side} failed:\n{run.stderr[-4000:]}")
        turn = json.loads(run.stdout.splitlines()[-1])
        libraries[side] = turn["library"]
        for tag, ms in turn["ms"].items():
            times[side].setdefault(tag, []).append(ms)
            print(f"{side} decode_attn[{tag}]: {ms:.4f} ms", flush=True)
    sass = {side: sass_by_kernel(lib) for side, lib in libraries.items()}
    differ = sorted(fn for fn in sass["B"]
                    if sass["A"].get(fn) != sass["B"][fn])
    print(f"SASS: {len(sass['B']) - len(differ)} of {len(sass['B'])} "
          f"instantiations identical to A's; differ: {differ}", flush=True)
    for fn in sass["B"]:  # where the first that differs starts to
        a, b = sass["A"].get(fn, []), sass["B"][fn]
        if a != b:
            at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      min(len(a), len(b)))
            print(f"  first difference in {fn} at instruction {at} "
                  f"of {len(a)} / {len(b)}: {a[at:at + 2]} / {b[at:at + 2]}",
                  flush=True)
            break
    print(json.dumps({"card": card, "A": str(sides["A"]),
                      "median_ms": {side: {tag: statistics.median(v)
                                           for tag, v in rows.items()}
                                    for side, rows in times.items()},
                      "ms": times, "sass_differs": differ}))


if __name__ == "__main__":
    main(sys.argv)
