"""What bounds ``decode_attn``'s int8 rows in one checkout of this
repository: each int8 instantiation's resources and SASS, and the rows
timed at several split counts.

    python3 tools/decode_attn_splits.py [CHECKOUT]   # on a CUDA host

CHECKOUT defaults to this one. It builds that checkout's library (as
``tools/decode_attn_ab.py`` does), then logs, for the bf16-q int8
instantiations at moonshot-v1-16b-a3b's (hd 128, G 1), yi-34b's (hd 128,
G 2), smollm's (hd 64, G 3) and stablelm-3b's (hd 80, G 1) shapes, the
registers, static shared memory and stack that ``cuobjdump -res-usage``
reports, the blocks an SM holds by registers alone (128 threads a block;
the int8 ring's dynamic shared memory caps them further, at 3 for hd
128), and the SASS instruction count with its most frequent opcodes.
Then ``[moonshot,int8]`` and ``[smollm,int8]`` (B 16, S 2048, pos 1087)
are timed with L2 flushed, as
``tools/decode_attn_ab.py`` times them, through the library's C entry
point at split lengths 128, 256, 384, 512 and 1024 (its own plan too,
through the wrapper), each held to the plain version (atol 1e-5, rtol
1e-4). A body that spreads positions 0..pos over its splits at run time
takes the same nsplit = ceil(S / split_len). Prints one JSON line last.
"""
from __future__ import annotations

import collections
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

L2_FLUSH_BYTES = 128 << 20
TOL = (1e-5, 1e-4)
SPLITS = (128, 256, 384, 512, 1024)
# (row, B, S, KV, G, hd, pos)
ROWS = (("moonshot,int8", 16, 2048, 16, 1, 128, 1087),
        ("smollm,int8", 16, 2048, 5, 3, 64, 1087))
# the int8 instantiations reported: (hd, G)
SHAPES = ((128, 1), (128, 2), (64, 3), (80, 1))


def _label(fn):
    m = re.search(r"decode_attn_kernelI13__nv_bfloat16aLi(\d+)ELi(\d+)E", fn)
    return (int(m.group(1)), int(m.group(2))) if m else None


def resources(lib_path):
    """{(hd, G): {registers, smem, instructions, top}} of the bf16-q int8
    instantiations in SHAPES."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    res = subprocess.run([tool, "-res-usage", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    fn = None
    for line in res.splitlines():
        m = re.search(r"Function (\w+):", line)
        if m:
            fn = _label(m.group(1))
            continue
        if fn in SHAPES:
            regs = re.search(r"REG:(\d+)", line)
            smem = re.search(r"SHARED:(\d+)", line)
            stack = re.search(r"STACK:(\d+)", line)
            if regs:
                out[fn] = {"registers": int(regs.group(1)),
                           "static_smem": int(smem.group(1)) if smem else 0,
                           "stack": int(stack.group(1)) if stack else 0}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for part in sass.split("Function : ")[1:]:
        key = _label(part.split()[0])
        if key not in SHAPES:
            continue
        ops = collections.Counter()
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", part):
            ops[op] += 1
        out.setdefault(key, {}).update(
            instructions=sum(ops.values()),
            top=dict(ops.most_common(12)))
    for key, r in out.items():
        regs = -(-r.get("registers", 0) // 8) * 8  # allocated in 8s
        r["blocks_by_registers"] = 65536 // (128 * max(regs, 1))
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        sys.exit("decode_attn_splits: torch.cuda.is_available() is false")
    checkout = Path(argv[1]).resolve() if len(argv) > 1 else \
        Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.models.layers import quantize_kv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    build.build(["decode_attn"])
    report = {"card": card, "checkout": str(checkout), "resources": {},
              "ms": {}}
    for (hd, G), r in sorted(resources(
            build.library_path("decode_attn")).items()):
        print(f"<bf16, int8_t, {hd}, {G}>: {r}", flush=True)
        report["resources"][f"{hd},{G}"] = r
    lib = dk._lib()
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

    def call(q, k, v, pos, split_len):
        B, KV, G, hd = q.shape
        S = k["q"].shape[1]
        kvg = dk.heads_per_block(KV, True)
        nsplit = -(-S // split_len)
        out = torch.empty((B, KV, G, hd), dtype=torch.float32,
                          device="cuda")
        pa = torch.empty((B * KV * nsplit * G * hd,), dtype=torch.float32,
                         device="cuda")
        pm = torch.empty((B * KV * nsplit * G * 2,), dtype=torch.float32,
                         device="cuda")
        err = lib.decode_attn(
            q.data_ptr(), k["q"].data_ptr(), v["q"].data_ptr(),
            k["s"].data_ptr(), v["s"].data_ptr(), None, out.data_ptr(),
            pa.data_ptr(), pm.data_ptr(), B, S, KV, G, hd, pos, split_len,
            nsplit, kvg, 1, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_attn failed with cudaError_t {err}")
        return out

    for tag, B, S, KV, G, hd, pos in ROWS:
        gen = torch.Generator(device="cuda").manual_seed(S + pos + hd)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((B, KV, G, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        q, k, v = q.to(torch.bfloat16), quantize_kv(k), quantize_kv(v)
        want = decode_attn_ref(q, k, v, pos)
        runs = [("own plan", lambda: dk.decode_attn_cuda(q, k, v, pos))]
        runs += [(f"split_len {n}", lambda n=n: call(q, k, v, pos, n))
                 for n in SPLITS]
        for name, fn in runs:
            got = fn()
            excess = float(((got - want).abs() - TOL[1] * want.abs()).max())
            if not bool(torch.isfinite(got).all()) or excess > TOL[0]:
                raise AssertionError(f"decode_attn[{tag}] {name} disagrees "
                                     f"with its plain version")
            ms = cold_ms(fn)
            print(f"decode_attn[{tag}] {name}: {ms:.5f} ms", flush=True)
            report["ms"][f"{tag} {name}"] = ms
        del q, k, v, want
        torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == "__main__":
    main(sys.argv)
