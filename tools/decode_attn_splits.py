"""What bounds ``decode_attn``'s int8 rows and its tensor-core bf16 rows
(G 5..8 and G 1) in one checkout of this repository: each int8
instantiation's resources and SASS, and the rows timed at several split
counts. On a CUDA host:

    python3 tools/decode_attn_splits.py [CHECKOUT] [--bf16 | --g1]

With ``--bf16`` only the bf16 sweep at G 5..8 runs (~3 min), with
``--g1`` only the bf16 sweep at G 1 (last below).

CHECKOUT defaults to this one. It builds that checkout's library (as
``tools/decode_attn_ab.py`` does), then logs, for the bf16-q int8
instantiations at moonshot-v1-16b-a3b's (hd 128, G 1), yi-34b's (hd 128,
G 2), smollm's (hd 64, G 3), stablelm-3b's (hd 80, G 1) and
llama-3.2-vision-90b's (hd 128, G 8) shapes, the registers, static
shared memory and stack that ``cuobjdump -res-usage`` reports, the
blocks an SM holds by registers alone at 128 threads a block (half as
many for the 256-thread blocks of the tensor-core body past G 4; the
int8 ring's dynamic shared memory caps them further, at 3 for hd 128),
and the SASS instruction count with its most frequent opcodes. Then
``[moonshot,int8]`` and ``[smollm,int8]`` (B 16, S 2048, pos 1087) are
timed with L2 flushed, as ``tools/decode_attn_ab.py`` times them,
through the library's C entry point at split lengths 128, 256, 384, 512
and 1024 (its own plan too, through the wrapper), each held to the plain
version (atol 1e-5, rtol 1e-4). A body that spreads positions 0..pos
over its splits at run time takes the same nsplit = ceil(S / split_len).

Then llama-3.2-vision-90b's two G-8 rows (its self layers: B 16, S 2048,
KV 8, pos 1087; its cross layers: S 6404, pos 6403) are swept the same
way over the KV heads a block (4, 2 and 1) and the split count (1 to 12
a row group), and over library variants that nvcc builds beside the
checkout's (``build/kernels/variants/``) with the G > 4 tensor-core
body's warps a block and ring depth set by ``-DDECODE_ATTN_WIDE_WARPS``
(4 and 8) and ``-DDECODE_ATTN_WIDE_NSTAGE`` (2, 3 and 4 tiles); each
variant's registers and spills of the bf16-q int8 instantiations at hd
64 and 128, G 5..8, are logged from ptxas; the one-head rows are timed
in two more rounds, in turns. Then the own plan is timed at several
positions of each G-8 row, and what a call costs beside its reads:
one elementwise kernel timed the same way, each variant and the own
plan at pos 0 (the plan twice in a row too), the bf16 cache's body and
SDPA over one position, and the kernel alone under ``torch.profiler``
(L2 hot) at pos 0 and at the row's pos.

Then jamba-1.5-large-398b's attention layer on its bf16 cache (B 16, S
2048, KV 8, G 8, hd 128, pos 1087), the tensor-core bf16 body's row, is
swept the same way over library variants with its warps a block and ring
depth set by ``-DDECODE_ATTN_BF16_WARPS`` (4, 8) and
``-DDECODE_ATTN_BF16_NSTAGE`` (2, 3; 6 at 4 warps), each at 1 to 4
splits a row (one KV head a block); each variant's registers and spills
of the bf16 instantiations at hd 64 and 128, G 5..8, from ptxas, and its
blocks an SM from the occupancy calculator, are logged; the 1- and
2-split runs are timed in more rounds, in turns (the CUDA-core body the
row took before is ``tools/decode_attn_ab.py``'s, against a parent
checkout). Then the own plan at several positions, the same bytes laid
out as 128 rows of one KV head (B 128, KV 1: a block's rows contiguous
in the cache, not 256 of each 2,048 bytes), and the same probes of what
a call costs beside its reads.

Last, seamless-m4t-large-v2's self (B 16, S 2048, KV 16, G 1, hd 64, pos
1087) and cross (S 1024, pos 1023) layers and olmoe-1b-7b's attention
(hd 128, S 2048, pos 1087) on their bf16 caches, the rows of the
tensor-core bf16 body at G 1 (``walk_bf16_mma``), swept over its library
variants: warps a block (``-DDECODE_ATTN_BF16_WARPS``, with
``-DDECODE_ATTN_BF16_NSTAGE=3`` at 8 so that G 5..8 still fit) and ring
tiles at G 1 at hd 64 and 128 (``-DDECODE_ATTN_BF16_G1_NSTAGE_64`` /
``_128``), each at 1 to 4 splits a row (one KV head a block); each
variant's registers and spills of the G-1 instantiations from ptxas, and
its blocks an SM, are logged; the 1- and 2-split runs are timed in more
rounds, in turns. Then the own plan at
several positions beside SDPA over as many (each one's loop rate and
fixed cost), the same bytes laid out as 256 rows of one KV head (B 256,
KV 1: a block's rows contiguous in the cache), one elementwise kernel,
each variant's one call and two calls in a row at pos 0, and the kernel
alone under ``torch.profiler``. Prints one JSON line last.
"""
from __future__ import annotations

import collections
import ctypes
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
SHAPES = ((128, 1), (128, 2), (64, 3), (80, 1), (128, 8))
# llama-3.2-vision-90b's G-8 rows, (row, B, S, KV, G, hd, pos), swept over
# the KV heads a block, the splits a row group and the library variants
# (warps a block, ring tiles) of the G > 4 tensor-core body; then the own
# plan at these positions of each
WIDE_ROWS = (("llama-vision,int8", 16, 2048, 8, 8, 128, 1087),
             ("llama-vision-xattn,int8", 16, 6404, 8, 8, 128, 6403))
WIDE_HEADS = (4, 2, 1)
WIDE_SPLITS = (1, 2, 3, 4, 6, 8, 12)
WIDE_VARIANTS = ((4, 2), (4, 3), (4, 4), (8, 2), (8, 3), (8, 4))
WIDE_ROUNDS = 2  # more rounds of the one-head rows, in turns
WIDE_POSITIONS = {"llama-vision,int8": (0, 255, 511, 1087, 2047),
                  "llama-vision-xattn,int8": (0, 1600, 3200, 6403)}
# jamba-1.5-large-398b's attention layer on its bf16 cache, (row, B, S,
# KV, G, hd, pos), swept over the tensor-core bf16 body's library variants
# (warps a block, ring tiles) and the splits a row
BF16_ROWS = (("jamba,bf16", 16, 2048, 8, 8, 128, 1087),)
BF16_VARIANTS = ((4, 2), (4, 3), (4, 6), (8, 2), (8, 3))
BF16_SPLITS = (1, 2, 3, 4)
BF16_ROUNDS = 2  # more rounds of the 1- and 2-split runs, in turns
BF16_POSITIONS = (0, 255, 511, 1087, 2047)
# seamless-m4t-large-v2's self and cross layers (hd 64) and olmoe-1b-7b's
# attention (hd 128) on their bf16 caches at G 1, (row, B, S, KV, G, hd,
# pos), swept over walk_bf16_mma's library variants and the splits a row;
# then the own plan at these positions of each
G1_ROWS = (("seamless,bf16", 16, 2048, 16, 1, 64, 1087),
           ("seamless-xattn,bf16", 16, 1024, 16, 1, 64, 1023),
           ("olmoe,bf16", 16, 2048, 16, 1, 128, 1087))
# (warps, ring tiles at hd 64, at hd 128): the first is the source's
# defaults
G1_VARIANTS = ((4, 6, 3), (4, 3, 2), (4, 4, 2), (8, 3, 2))
G1_SPLITS = (1, 2, 3, 4)
G1_ROUNDS = 2  # more rounds of the 1- and 2-split runs, in turns
G1_POSITIONS = {"seamless,bf16": (0, 255, 511, 1087, 2047),
                "seamless-xattn,bf16": (0, 255, 511, 1023),
                "olmoe,bf16": (0, 255, 511, 1087, 2047)}


def _label(fn):
    m = re.search(r"decode_attn_kernelI13__nv_bfloat16aLi(\d+)ELi(\d+)E", fn)
    return (int(m.group(1)), int(m.group(2))) if m else None


def _bf16_label(fn):
    """(hd, G) of a ``decode_attn_kernel<bf16, bf16, hd, G>``, else None."""
    m = re.search(r"decode_attn_kernelI13__nv_bfloat16S\d*_Li(\d+)ELi(\d+)E",
                  fn)
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


def build_variants(build, lib_argtypes, flags, label,
                   keep=lambda hd, G: hd in (64, 128) and G > 4):
    """{key: (library, {(hd, G): ptxas line})} of the library variants
    ``flags`` ({key: (file tag, nvcc -D flags)}), one nvcc each, run
    together; the lines of the instantiations that ``label`` names (hd,
    G) where ``keep(hd, G)`` (default: hd 64 and 128, G 5..8). Raises with
    nvcc's stderr if a variant fails to build."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.KERNELS_DIR / build.SOURCES["decode_attn"]
    procs = {}
    for key, (tag, defines) in flags.items():
        lib = out_dir / f"libdecode_attn-{tag}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(lib),
               str(src)]
        procs[key] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    variants = {}
    for key, (lib, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{stderr}")
        report, fn = stdout + stderr, None
        lines = collections.defaultdict(list)
        for text in report.splitlines():
            m = re.search(r"entry function '(\w+)'", text)
            if m:
                fn = label(m.group(1))
            elif (fn and keep(*fn)
                  and ("registers" in text or "spill" in text)):
                lines[fn].append(text.strip())
        handle = ctypes.CDLL(str(lib))
        lib_argtypes(handle)
        variants[key] = (handle, {f: " ".join(t) for f, t in
                                  sorted(lines.items())})
    return variants


def main(argv):
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("decode_attn_splits: torch.cuda.is_available() is false")
    only_bf16, only_g1 = "--bf16" in argv[1:], "--g1" in argv[1:]
    if only_bf16 and only_g1:
        sys.exit("decode_attn_splits: --bf16 or --g1, not both")
    int8_sweeps = not (only_bf16 or only_g1)
    paths = [a for a in argv[1:] if a not in ("--bf16", "--g1")]
    checkout = Path(paths[0]).resolve() if paths else \
        Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.models.layers import cache_read, quantize_kv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    build.build(["decode_attn"])

    def argtypes(handle):
        for fn in ("decode_attn", "decode_attn_blocks_per_sm"):
            getattr(handle, fn).argtypes = getattr(dk._lib(), fn).argtypes
            getattr(handle, fn).restype = getattr(dk._lib(), fn).restype

    variants = {} if not int8_sweeps else build_variants(
        build, argtypes,
        {(w, ns): (f"w{w}r{ns}", [f"-DDECODE_ATTN_WIDE_WARPS={w}",
                                  f"-DDECODE_ATTN_WIDE_NSTAGE={ns}"])
         for w, ns in WIDE_VARIANTS}, _label)
    bf16_variants = {} if only_g1 else build_variants(
        build, argtypes,
        {(w, ns): (f"bf16-w{w}r{ns}", [f"-DDECODE_ATTN_BF16_WARPS={w}",
                                       f"-DDECODE_ATTN_BF16_NSTAGE={ns}"])
         for w, ns in BF16_VARIANTS}, _bf16_label)
    g1_variants = {} if only_bf16 else build_variants(
        build, argtypes,
        {key: (_g1_tag(key),
               [f"-DDECODE_ATTN_BF16_WARPS={key[0]}",
                f"-DDECODE_ATTN_BF16_G1_NSTAGE_64={key[1]}",
                f"-DDECODE_ATTN_BF16_G1_NSTAGE_128={key[2]}"]
               + (["-DDECODE_ATTN_BF16_NSTAGE=3"] if key[0] == 8 else []))
         for key in G1_VARIANTS}, _bf16_label,
        keep=lambda hd, G: hd in (64, 128) and G == 1)
    report = {"card": card, "checkout": str(checkout), "resources": {},
              "ms": {}, "variants": {}}
    if int8_sweeps:
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

    def kernel_ms(fn, calls=20):
        """decode_attn_kernel's mean device time a call, from the CUDA
        activity torch.profiler records over ``calls`` eager calls."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.self_device_time_total for e in prof.key_averages()
                 if "decode_attn_kernel" in e.key]
        return sum(times) / 1e3 / calls

    def call(q, k, v, pos, split_len, kvg=None, handle=lib):
        """One launch through ``handle``'s C entry: the int8 form, or a
        bf16 cache (k and v tensors)."""
        B, KV, G, hd = q.shape
        int8 = isinstance(k, dict)
        S = (k["q"] if int8 else k).shape[1]
        kvg = kvg or dk.heads_per_block(KV, int8)
        nsplit = -(-S // split_len)
        out = torch.empty((B, KV, G, hd), dtype=torch.float32,
                          device="cuda")
        pa = torch.empty((B * KV * nsplit * G * hd,), dtype=torch.float32,
                         device="cuda")
        pm = torch.empty((B * KV * nsplit * G * 2,), dtype=torch.float32,
                         device="cuda")
        kq, vq = (k["q"], v["q"]) if int8 else (k, v)
        ks, vs = ((k["s"].data_ptr(), v["s"].data_ptr()) if int8
                  else (None, None))
        err = handle.decode_attn(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs, None,
            out.data_ptr(), pa.data_ptr(), pm.data_ptr(), B, S, KV, G, hd,
            pos, split_len, nsplit, kvg, 1, int(int8),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_attn failed with cudaError_t {err}")
        return out

    for (warps, ns), (_, lines) in variants.items():
        for (hd, G), line in lines.items():
            name = f"{warps} warps, ring {ns}: <bf16, int8_t, {hd}, {G}>"
            print(f"variant {name}: {line}", flush=True)
            report["variants"][name] = line
    named = [(f"{w} warps, ring {ns}", v)
             for (w, ns), v in bf16_variants.items()]
    named += [(_g1_name(key), v) for key, v in g1_variants.items()]
    for vname, (handle, lines) in named:
        for (hd, G), line in lines.items():
            blocks = ctypes.c_int(0)
            err = handle.decode_attn_blocks_per_sm(1, 0, hd, G,
                                                   ctypes.addressof(blocks))
            name = f"{vname}: <bf16, bf16, {hd}, {G}>"
            line = f"{line}; {blocks.value} blocks an SM (error {err})"
            print(f"variant {name}: {line}", flush=True)
            report["variants"][name] = line

    def timed(tag, name, fn, want=None):
        """fn's time (cold_ms), logged; first held to ``want``, the plain
        version, where given."""
        if want is not None:
            got = fn()
            excess = float(((got - want).abs() - TOL[1] * want.abs()).max())
            if not bool(torch.isfinite(got).all()) or excess > TOL[0]:
                raise AssertionError(f"decode_attn[{tag}] {name} disagrees "
                                     f"with its plain version")
        ms = cold_ms(fn)
        print(f"decode_attn[{tag}] {name}: {ms:.5f} ms", flush=True)
        report["ms"][f"{tag} {name}"] = ms

    for tag, B, S, KV, G, hd, pos in ROWS + WIDE_ROWS if int8_sweeps else ():
        gen = torch.Generator(device="cuda").manual_seed(S + pos + hd)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((B, KV, G, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        q, k, v = q.to(torch.bfloat16), quantize_kv(k), quantize_kv(v)
        want = decode_attn_ref(q, k, v, pos)
        # (name, call, its pos)
        runs = [("own plan", lambda: dk.decode_attn_cuda(q, k, v, pos),
                 pos)]
        if G <= 4:
            runs += [(f"split_len {n}", lambda n=n: call(q, k, v, pos, n),
                      pos) for n in SPLITS]
        else:  # ceil(S / split_len) = nsplit for these S and nsplit
            runs += [(f"{warps} warps, ring {ns}, {kvg} heads, {n} splits",
                      lambda n=n, kvg=kvg, h=handle: call(
                          q, k, v, pos, -(-S // n), kvg, h), pos)
                     for (warps, ns), (handle, _) in variants.items()
                     for kvg in WIDE_HEADS for n in WIDE_SPLITS]
            runs += [(f"{warps} warps, ring {ns}, 1 heads, {n} splits "
                      f"(round {r + 2})",
                      lambda n=n, h=handle: call(q, k, v, pos, -(-S // n),
                                                 1, h), pos)
                     for r in range(WIDE_ROUNDS)
                     for (warps, ns), (handle, _) in variants.items()
                     for n in (1, 2)]
            runs += [(f"own plan at pos {p}",
                      lambda p=p: dk.decode_attn_cuda(q, k, v, p), p)
                     for p in WIDE_POSITIONS[tag]]
        wants = {pos: want}
        for name, fn, at in runs:
            if at not in wants:
                wants[at] = decode_attn_ref(q, k, v, at)
            timed(tag, name, fn, wants[at])
        if G > 4:  # what a call costs beside its reads, timed the same way
            small = torch.zeros(q.shape, device="cuda")
            kb, vb = (cache_read(c, torch.bfloat16) for c in (k, v))
            qh = q.reshape(B, KV * G, 1, hd)
            kh, vh = (t.transpose(1, 2) for t in (kb, vb))
            probes = [("floor: one elementwise kernel on a tensor of the "
                       "output's size", lambda: small.add_(1.0))]
            probes += [(f"{warps} warps, ring {ns}, 1 heads, 1 splits at "
                        f"pos 0", lambda h=handle: call(q, k, v, 0, S, 1, h))
                       for (warps, ns), (handle, _) in variants.items()]
            probes += [("own plan at pos 0, two calls",
                        lambda: (dk.decode_attn_cuda(q, k, v, 0),
                                 dk.decode_attn_cuda(q, k, v, 0))),
                       ("bf16 cache, own plan at pos 0",
                        lambda: dk.decode_attn_cuda(q, kb, vb, 0)),
                       ("SDPA over one position of the bf16 cache",
                        lambda: F.scaled_dot_product_attention(
                            qh, kh[:, :, :1], vh[:, :, :1],
                            enable_gqa=True))]
            for name, fn in probes:
                timed(tag, name, fn)
            # the kernel's own time, without launches
            for name, p, c in (("own plan", 0, (k, v)),
                               ("own plan", pos, (k, v)),
                               ("bf16 cache, own plan", 0, (kb, vb))):
                ms = kernel_ms(lambda p=p, c=c: dk.decode_attn_cuda(q, *c, p))
                print(f"decode_attn[{tag}] {name} at pos {p}: the kernel "
                      f"alone under torch.profiler, L2 hot: {ms:.5f} ms",
                      flush=True)
                report["ms"][f"{tag} {name} at pos {p}, profiler"] = ms
            del small, kb, vb, qh, kh, vh
        del q, k, v, want, wants
        torch.cuda.empty_cache()

    for tag, B, S, KV, G, hd, pos in () if only_g1 else BF16_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(S + pos + hd)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda"
                               ).to(torch.bfloat16)
                   for shape in ((B, KV, G, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        want = decode_attn_ref(q, k, v, pos)
        tc = {key: h for key, (h, _) in bf16_variants.items()}
        runs = [("own plan", lambda: dk.decode_attn_cuda(q, k, v, pos))]
        runs += [(f"{w} warps, ring {ns}, {n} splits",
                  lambda n=n, h=h: call(q, k, v, pos, -(-S // n), 1, h))
                 for (w, ns), h in tc.items() for n in BF16_SPLITS]
        runs += [(f"{w} warps, ring {ns}, {n} splits (round {r + 2})",
                  lambda n=n, h=h: call(q, k, v, pos, -(-S // n), 1, h))
                 for r in range(BF16_ROUNDS) for (w, ns), h in tc.items()
                 for n in (1, 2)]
        for name, fn in runs:
            timed(tag, name, fn, want)
        for p in BF16_POSITIONS:
            timed(tag, f"own plan at pos {p}",
                  lambda p=p: dk.decode_attn_cuda(q, k, v, p),
                  decode_attn_ref(q, k, v, p))
        # the same bytes and blocks, each block's rows contiguous
        q1, k1, v1 = (t.reshape(shape).contiguous() for t, shape in (
            (q, (B * KV, 1, G, hd)), (k, (B * KV, S, 1, hd)),
            (v, (B * KV, S, 1, hd))))
        timed(tag, f"own plan, as B {B * KV}, KV 1 (rows contiguous)",
              lambda: dk.decode_attn_cuda(q1, k1, v1, pos),
              decode_attn_ref(q1, k1, v1, pos))
        del q1, k1, v1
        # what a call costs beside its reads, timed the same way
        small = torch.zeros(q.shape, device="cuda")
        qh = q.reshape(B, KV * G, 1, hd)
        kh, vh = (t.transpose(1, 2) for t in (k, v))
        kv_valid = [t[:, :, :pos + 1] for t in (kh, vh)]
        probes = [("floor: one elementwise kernel on a tensor of the "
                   "output's size", lambda: small.add_(1.0)),
                  ("own plan at pos 0", lambda: dk.decode_attn_cuda(q, k, v,
                                                                    0)),
                  ("own plan at pos 0, two calls",
                   lambda: (dk.decode_attn_cuda(q, k, v, 0),
                            dk.decode_attn_cuda(q, k, v, 0))),
                  ("SDPA over one position", lambda: (
                      F.scaled_dot_product_attention(
                          qh, kh[:, :, :1], vh[:, :, :1], enable_gqa=True))),
                  ("SDPA over the valid positions (the library call)",
                   lambda: F.scaled_dot_product_attention(
                       qh, *kv_valid, enable_gqa=True))]
        probes += [(f"{w} warps, ring {ns}, 1 splits at pos 0",
                    lambda h=h: call(q, k, v, 0, S, 1, h))
                   for (w, ns), h in tc.items()]
        for name, fn in probes:
            timed(tag, name, fn)
        for p in (0, pos):  # the kernel's own time, without launches
            ms = kernel_ms(lambda p=p: dk.decode_attn_cuda(q, k, v, p))
            print(f"decode_attn[{tag}] own plan at pos {p}: the kernel alone "
                  f"under torch.profiler, L2 hot: {ms:.5f} ms", flush=True)
            report["ms"][f"{tag} own plan at pos {p}, profiler"] = ms
        del q, k, v, want, small, qh, kh, vh, kv_valid
        torch.cuda.empty_cache()

    for tag, B, S, KV, G, hd, pos in () if only_bf16 else G1_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(S + pos + hd)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda"
                               ).to(torch.bfloat16)
                   for shape in ((B, KV, G, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        want = decode_attn_ref(q, k, v, pos)
        tc = {_g1_name(key): h for key, (h, _) in g1_variants.items()}
        runs = [("own plan", lambda: dk.decode_attn_cuda(q, k, v, pos))]
        runs += [(f"{vn}, {n} splits",
                  lambda n=n, h=h: call(q, k, v, pos, -(-S // n), 1, h))
                 for vn, h in tc.items() for n in G1_SPLITS]
        runs += [(f"{vn}, {n} splits (round {r + 2})",
                  lambda n=n, h=h: call(q, k, v, pos, -(-S // n), 1, h))
                 for r in range(G1_ROUNDS) for vn, h in tc.items()
                 for n in (1, 2)]
        for name, fn in runs:
            timed(tag, name, fn, want)
        qh = q.reshape(B, KV * G, 1, hd)
        kh, vh = (t.transpose(1, 2) for t in (k, v))
        for p in G1_POSITIONS[tag]:  # the loops' rates and fixed costs
            timed(tag, f"own plan at pos {p}",
                  lambda p=p: dk.decode_attn_cuda(q, k, v, p),
                  decode_attn_ref(q, k, v, p))
            timed(tag, f"SDPA over positions 0..{p}",
                  lambda p=p: F.scaled_dot_product_attention(
                      qh, kh[:, :, :p + 1], vh[:, :, :p + 1],
                      enable_gqa=True))
        # the same bytes and blocks, each block's rows contiguous
        q1, k1, v1 = (t.reshape(shape).contiguous() for t, shape in (
            (q, (B * KV, 1, G, hd)), (k, (B * KV, S, 1, hd)),
            (v, (B * KV, S, 1, hd))))
        timed(tag, f"own plan, as B {B * KV}, KV 1 (rows contiguous)",
              lambda: dk.decode_attn_cuda(q1, k1, v1, pos),
              decode_attn_ref(q1, k1, v1, pos))
        del q1, k1, v1
        # what a call costs beside its reads, timed the same way
        small = torch.zeros(q.shape, device="cuda")
        probes = [("floor: one elementwise kernel on a tensor of the "
                   "output's size", lambda: small.add_(1.0))]
        probes += [(f"{vn}, 1 splits at pos 0",
                    lambda h=h: call(q, k, v, 0, S, 1, h))
                   for vn, h in tc.items()]
        probes += [(f"{vn}, 1 splits at pos 0, two calls",
                    lambda h=h: (call(q, k, v, 0, S, 1, h),
                                 call(q, k, v, 0, S, 1, h)))
                   for vn, h in tc.items()]
        for name, fn in probes:
            timed(tag, name, fn)
        for p in (0, pos):  # the kernel's own time, without launches
            ms = kernel_ms(lambda p=p: dk.decode_attn_cuda(q, k, v, p))
            print(f"decode_attn[{tag}] own plan at pos {p}: the kernel alone "
                  f"under torch.profiler, L2 hot: {ms:.5f} ms", flush=True)
            report["ms"][f"{tag} own plan at pos {p}, profiler"] = ms
        del q, k, v, want, small, qh, kh, vh
        torch.cuda.empty_cache()
    print(json.dumps(report))


def _g1_tag(key):
    """The file tag of walk_bf16_mma's G-1 library variant ``key`` (warps,
    tiles at hd 64, at hd 128)."""
    return "g1-w{}r{}-{}".format(*key)


def _g1_name(key):
    """The log name of walk_bf16_mma's G-1 library variant ``key``."""
    return "{} warps, ring {}/{}".format(*key)


if __name__ == "__main__":
    main(sys.argv)
