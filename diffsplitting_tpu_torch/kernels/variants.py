"""Build and time variants of one of csrc/*.cu on one card.

A variant is the shipped source and the headers it includes (csrc/*.cuh)
with text substitutions in either; a baseline is any other source with the
same entry point. Each is written to a directory of its own and built by its
own `nvcc` into its own library, all started together, so a variant's header
shadows the shipped one. Shared by `attention_variants`,
`conv_gn_variants` and `groupnorm_variants`; nothing here is used by the port.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

from .build import COMPILE_FLAGS, CSRC, _nvcc


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def variant_sources(source: str, variants: dict) -> dict:
    """name -> {file name: text}: csrc/`source` and csrc/*.cuh with each
    variant's (file name, old, new) substitutions applied."""
    base = {source: (CSRC / source).read_text()}
    base.update({h.name: h.read_text() for h in sorted(CSRC.glob("*.cuh"))})
    out = {}
    for name, subs in variants.items():
        files = dict(base)
        for fname, old, new in subs:
            if old not in files[fname]:
                raise RuntimeError(f"variant {name}: {fname} no longer holds {old!r}")
            files[fname] = files[fname].replace(old, new)
        out[name] = files
    return out


def baseline_sources(path: Path, name: str = None) -> dict:
    """{file name: text}: an earlier source (as `name`, else its own) and the
    headers beside it (its own csrc/*.cuh, e.g. `git archive <commit>
    diffsplitting_tpu_torch/csrc` unpacked), which shadow the shipped ones:
    today's headers need not hold what an older source includes."""
    files = {h.name: h.read_text() for h in sorted(path.parent.glob("*.cuh"))}
    files[name or path.name] = path.read_text()
    return files


def build_all(sources: dict, main, work: Path) -> dict:
    """Build each variant's `main` file (its headers beside it) into a
    library; print its registers and spills; return name -> CDLL. `main` is
    one file name, or name -> file name."""
    procs = {}
    for name, files in sources.items():
        d = work / name
        d.mkdir()
        for fname, text in files.items():
            (d / fname).write_text(text)
        src = main if isinstance(main, str) else main[name]
        cmd = [_nvcc(), *COMPILE_FLAGS, "-I", str(CSRC), "-shared", "-o", str(d / "lib.so"),
               str(d / src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        print(f"{name}: " + "; ".join(ptxas_summary(out)))
        libs[name] = ctypes.CDLL(str(work / name / "lib.so"))
    return libs


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name
    (_Z[N]<length><identifier>... then any I...E arguments)."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, name = m.end(), mangled
    while (d := re.match(r"\d+", mangled[pos:])):
        n = int(d.group())
        name = mangled[pos + d.end():pos + d.end() + n]
        pos += d.end() + n
    rest = mangled[pos:]
    if rest.startswith("I"):
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", rest.split("EE")[0] + "E")) + ">"
    return name


def ptxas_summary(log: str) -> list:
    """'kernel<template args>: registers, spill bytes' for each entry function
    in an `-Xptxas -v` log."""
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spill = line.split(",")[1].strip().split()[0]
        elif "Used" in line and name:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers, {spill} B spilled")
            name = None
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi gives it, in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return float(out.split()[0]) * 1e6


def exp2_ms(count: int, sms: int, clock_hz: float) -> float:
    """The least time for `count` exp2 on the card: 16 a clock an SM (the
    special-function units)."""
    return count / (16 * sms * clock_hz) * 1e3


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn over `iters` calls captured in one CUDA graph
    and replayed: the kernels' own time, without the host's time to issue
    them. fn must launch on the current stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)
