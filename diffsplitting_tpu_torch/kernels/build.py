"""Build and load the port's CUDA kernels (csrc/*.cu) as one plain-C library.

Each source is compiled by its own `nvcc` process, all started together, for
`sm_90a`; the objects are linked into one shared library that `ctypes` loads.
Nothing here includes PyTorch's headers, so a build takes seconds. The
library is built at first use into `build/torch_kernels/` at the root of the
checkout, named by a hash of the sources, the headers they share (csrc/*.cuh)
and the flags, so an edited source builds anew. A failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ARCH + ("-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of csrc/*.cu; pointers and the stream are c_void_p so that
# ctypes does not cut them to 32 bits
SIGNATURES = {
    "gn_swish_f32": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _LL, _F, _P],
    "gn_swish_bf16": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _LL, _F, _P],
    "attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _F, _I, _P],
    "attention_f32_d128": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _F, _I, _P],
    "attention_f32_narrow": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _F, _I, _I,
                             _I, _P],
    "attention_f32_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _F, _I, _I,
                           _I, _P],
    "conv_gn_f32": [_P, _P, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "conv_gn_bf16": [_P, _P, _I, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _I, _LL, _LL, _P, _P, _P,
                     _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + list(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str]:
    """Compile and link csrc/*.cu unless this exact build exists.

    Returns the library's path and the compiler's log (`-Xptxas -v` lists
    each kernel's registers, shared memory and spills)."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib = BUILD_DIR / f"libdsp_torch_kernels_{_digest(sources)}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp_"))
    try:
        jobs = []
        for src in sources:
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp_lib = work / lib.name
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp_lib), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}{link.stderr}")
        log_path.write_text(log)
        os.replace(tmp_lib, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use, with argtypes set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
