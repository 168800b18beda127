"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``_build/<name>-<hash>.so``, a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  The hash covers the source, every
``csrc/*.cuh`` header and the flags, so an edited source rebuilds and an
unchanged one is reused.  Builds run at first use; :func:`build` starts one
nvcc per stale source, all at once, and raises if any of them fails.

A covariance registered with CUDA bodies (``ops.rbf.register_tile_covar``)
gets builds of its own: :func:`covar_header` writes its bodies as the
``user_covar`` and ``user_dcovar`` of ``csrc/covar.cuh``, nvcc takes that
text as a pre-included header, and the text is part of the hash
(``_build/<name>-covar-<hash>.so``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The instantiation each source runs on the GP main path (RBF, d = 3; K1 at
# 72 columns, K3 and K5 at 16, K2 at one k-step of 16, K4 with d unpadded),
# by a part of its mangled name, for ptxas_report
MAIN_PATH_KERNELS = {
    "kernel_matvec": "matvec_kernelILi0ELi9ELi4E",
    "kernel_matvec_sym": "sym_matvec_kernelILi0ELi2ELi4E",
    "kernel_matvec_cached": "matvec_cached_kernelILi2E",
    "kernel_weighted": "weighted_kernelILi0ELi1ELi3E",
    "kernel_build_sym": "build_sym_tiles_kernelILi0ELi3E",
}

_loaded: dict[tuple[str, str], ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """The path of the CUDA toolkit's nvcc."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def covar_header(covar: str, dcovar: str) -> str:
    """The header that compiles a registered covariance into the kernels:
    ``covar`` and ``dcovar`` are CUDA C++ expressions of the float ``d2``
    (k(d2) and dk/d(d2))."""
    return (
        "#pragma once\n#include <cuda_runtime.h>\n#define LO_USER_COVAR 1\n"
        f"__device__ __forceinline__ float user_covar(float d2) {{ return ({covar}); }}\n"
        f"__device__ __forceinline__ float user_dcovar(float d2) {{ return ({dcovar}); }}\n"
    )


def library_path(name: str, header: str = "") -> Path:
    """The library of ``csrc/<name>.cu``, built with the pre-included
    ``header`` text (a :func:`covar_header`) when one is given."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(header.encode())
    return BUILD_DIR / f"{name}{'-covar' if header else ''}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None, header: str = "") -> dict[str, float]:
    """Compile every stale library among ``names`` (default: all sources) in
    parallel, with the pre-included ``header`` text when one is given.
    Returns the seconds each build took (0.0 when reused).  The ptxas report
    (registers, spills) is kept beside each library as
    ``<name>-<hash>.log``."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {name: 0.0 for name in names}
    for name in names:
        out = library_path(name, header)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        if header:
            pre = out.with_suffix(".cuh")
            pre.write_text(header)
            cmd[1:1] = ["-include", str(pre)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return times


def load(name: str, path: Path | None = None, header: str = "") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with the pre-included
    ``header``), built first if needed.  With ``path``, the library there
    (another build of the same source) is loaded and serves every later call
    in its place."""
    key = (name, header)
    if path is not None:
        _loaded[key] = ctypes.CDLL(str(path))
    elif key not in _loaded:
        path = library_path(name, header)
        if not path.exists():
            build([name], header)
        _loaded[key] = ctypes.CDLL(str(path))
    return _loaded[key]


def ptxas_summary(log: str) -> str:
    """How many kernel instantiations a ptxas report lists, the most
    registers any of them uses, and how many spill."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [ln for ln in log.splitlines() if "spill stores" in ln and " 0 bytes spill stores" not in ln]
    return f"{len(regs)} kernels, at most {max(regs, default=0)} registers, {len(spills)} spill"


def ptxas_report(log: str, mangled: str) -> str:
    """The ptxas lines (stack frame and spills, registers) of the
    instantiation whose mangled name contains ``mangled``."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and mangled in ln:
            report = [x.strip() for x in lines[i + 1 : i + 4] if "bytes stack frame" in x or "Used" in x]
            return "; ".join(r.replace("ptxas info    : ", "") for r in report)
    return "not found"
