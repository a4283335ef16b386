"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is one ``.cu`` file with a plain C interface, compiled at
first use for ``sm_90a`` into ``build/kernels/`` at the repository root.
The file name carries a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded. :func:`build` starts one
nvcc per library, all together, and raises with nvcc's stderr if one
fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: library name -> its CUDA source, relative to this directory
SOURCES = {"mbcodec": "mbcodec/csrc/mbcodec.cu",
           "accgrad_reduce": "accgrad_reduce/csrc/accgrad_reduce.cu",
           "decode_attn": "decode_attn/csrc/decode_attn.cu",
           "wkv6": "wkv6/csrc/wkv6.cu"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # the CUDA toolkit's default install prefix
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built on a host with the CUDA "
                           "toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = (KERNELS_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc each, run concurrently. Returns ``{name: (seconds, log)}``
    for each library compiled, ``log`` being nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names or SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(KERNELS_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({proc.returncode}):\n"
                          f"{stderr}")
            continue
        tmp.replace(out)  # atomic: a concurrent loader sees all or nothing
        done[name] = (time.perf_counter() - t0, stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.lru_cache()
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
