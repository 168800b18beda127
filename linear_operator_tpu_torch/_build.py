"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``_build/<name>-<hash>.so``, a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  The hash covers the source, every
``csrc/*.cuh`` header and the flags, so an edited source rebuilds and an
unchanged one is reused.  Builds run at first use; :func:`build` starts one
nvcc per stale source, all at once, and raises if any of them fails.
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
# The instantiation each source runs on the GP main path (RBF, d <= 4; K1 at
# 72 columns, K3 at 16), by a part of its mangled name, for ptxas_report
MAIN_PATH_KERNELS = {
    "kernel_matvec": "matvec_kernelILi0ELi9ELi4E",
    "kernel_matvec_sym": "sym_matvec_kernelILi0ELi2ELi4E",
}

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """The path of the CUDA toolkit's nvcc."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every stale library among ``names`` (default: all sources) in
    parallel.  Returns the seconds each build took (0.0 when reused).  The
    ptxas report (registers, spills) is kept beside each library as
    ``<name>-<hash>.log``."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {name: 0.0 for name in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
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


def load(name: str, path: Path | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.  With
    ``path``, the library there (another build of the same source) is loaded
    and serves every later call in its place."""
    if path is not None:
        _loaded[name] = ctypes.CDLL(str(path))
    elif name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


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
