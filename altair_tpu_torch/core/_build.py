"""Build the CUDA kernels of ``altair_tpu_torch/csrc`` with nvcc and load
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so nvcc compiles it into a
shared library in seconds (no PyTorch headers).  The library lands in
``build/`` at the repository root, named by a hash of the source, the
shared headers and the flags, so a changed source or header rebuilds and
an unchanged one loads at once.  Nothing here runs at import time: the
first launch builds every kernel; ``build`` starts one nvcc per kernel at
once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# No --use_fast_math: the kernels need the full-precision sqrtf, rsqrtf,
# sinf, cosf, logf and expf of their plain PyTorch versions.  -fmad=false
# keeps nvcc from contracting a*b+c into one rounding, so a kernel does the
# float operations its plain version does and the two agree per lane on the
# card.  On an H100 (700 W) contraction saved 3-4% of the bounce kernel's
# time (16% for SPECULAR), and every scatter law then drifted past the
# 1e-3 cm kernel-vs-plain check (see PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    of every header in ``csrc/`` (``*.cuh``, which the kernels share) and
    of the flags, so an edited header rebuilds every kernel.  The
    compiler's output, with the register and spill counts ptxas reports,
    lies beside it with the suffix ``.log``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build every ``csrc/<name>.cu`` of ``names`` that is not built yet:
    one nvcc process each, all started at once, all waited for."""
    jobs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = CSRC / f"{name}.cu"
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        lib.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
        else:
            os.replace(tmp, lib)   # atomic: a concurrent build never half-loads
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.  The first build
    takes every ``csrc/*.cu`` not built yet, one nvcc each at once, so a
    path that launches two kernels waits for one build."""
    build(*sorted(p.stem for p in CSRC.glob("*.cu")))
    return ctypes.CDLL(str(library_path(name)))
