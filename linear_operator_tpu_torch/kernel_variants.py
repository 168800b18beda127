"""Time variants of K1 and K3 beside the kernels as built, on one GPU.

    python3 -m linear_operator_tpu_torch.kernel_variants

Each variant is a copy of ``csrc/kernel_matvec.cu`` or
``csrc/kernel_matvec_sym.cu`` with a textual change (:data:`VARIANTS`),
compiled with the package's nvcc flags into ``_build/variants/`` and loaded
in place of the built library.  At the main path's shapes (N = 100,000,
d = 3, RBF; K3 at t = 11, K1 at t = 65) every library is timed with CUDA
events, in turns, and held against ``kernel_matvec_acc3_plain``.  The
variants say what holds each kernel back:

  K1 unroll2     the 16-point chunk loop unrolled twice (more overlap, more
                 registers);
  K1 form_only   no products: the kernel entries are formed and split, and
                 folded into the output without an mma (wrong by design);
  K1 mma_only    no formation: constant fragments go through the three
                 products (wrong by design);
  K3 unroll1     the chunk loop not unrolled;
  K3 row_only    every tile treated as a diagonal one: no column
                 contribution, no column reduction (wrong by design);
  K3 no_atomic   the column sums are reduced but not added to y (wrong by
                 design).

Prints the main-path instantiation's ptxas report of each library, one line
per library and round, then one JSON object of the medians.  Without a CUDA
device it fails at once.  ``tests/test_torch_kernels.py`` checks that every
variant still applies to its source.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys

from . import _build

REPS = 5  # launches per timing, after one warm-up launch
ROUNDS = 2  # turns over all libraries; the medians are printed

# source -> variant -> (text to replace, its replacement) pairs; each text
# must occur in the source exactly once
VARIANTS = {
    "kernel_matvec": {
        "unroll2": [("#pragma unroll 1\n    for (int kc", "#pragma unroll 2\n    for (int kc")],
        "form_only": [("          acc3(part, a[mb], vf);",
                       "          part[0] = __uint_as_float(a[mb].hi[0] ^ a[mb].lo[1] ^ a[mb].hi[2] ^ a[mb].lo[3] ^ vf.hi[0]);\n"
                       "          part[1] = __uint_as_float(a[mb].lo[0] ^ a[mb].hi[1] ^ a[mb].lo[2] ^ a[mb].hi[3] ^ vf.lo[1]);")],
        "mma_only": [("        a[mb] = covar_block<COVAR>(d2, alpha);",
                      "        a[mb] = split_block({{d2[0][0] * 0.0f + kc, 1.0f, 0.5f, 0.25f}, {0.125f, 1.0f, 0.5f, 0.25f}});")],
    },
    "kernel_matvec_sym": {
        "unroll1": [("#pragma unroll 2\n    for (int kc", "#pragma unroll 1\n    for (int kc")],
        "row_only": [("    const bool diag = bj == bi;", "    const bool diag = true;")],
        "no_atomic": [("        atomicAdd(reinterpret_cast<float4*>", "        if (s.x == 12345.0f) atomicAdd(reinterpret_cast<float4*>")],
    },
}


def patched(src: str, variant: str) -> str:
    """The text of ``csrc/<src>.cu`` with ``variant``'s changes; raises if a
    text to replace is not in the source exactly once."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    for old, new in VARIANTS[src][variant]:
        if text.count(old) != 1:
            raise ValueError(f"variant {variant} of csrc/{src}.cu: {old!r} is not in the source exactly once")
        text = text.replace(old, new)
    return text


def registers(log: str, src: str) -> str:
    """Registers and spill stores of ``src``'s main-path instantiation."""
    return _build.ptxas_report(log, _build.MAIN_PATH_KERNELS[src])


def main() -> None:
    import torch

    from .ops import rbf

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this script times kernels on a GPU", file=sys.stderr, flush=True)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)

    # the libraries as built, then one patched copy of the source per variant,
    # all compiled at once
    _build.build(list(VARIANTS))
    libs = {(src, "built"): _build.library_path(src) for src in VARIANTS}
    logs = {key: path.with_suffix(".log").read_text() for key, path in libs.items()}
    work = _build.BUILD_DIR / "variants"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    procs = {}
    for src, variants in VARIANTS.items():
        for name in variants:
            cu = work / f"{src}-{name}.cu"
            cu.write_text(patched(src, name))
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
            procs[(src, name)] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"FAIL: nvcc failed for variant {key}:\n{log}", file=sys.stderr, flush=True)
            sys.exit(1)
        libs[key] = work / f"{key[0]}-{key[1]}.so"
        logs[key] = log
    for (src, name), log in logs.items():
        print(f"{src} {name}: main-path instantiation {registers(log, src)}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, d = 100_000, 3
    x = torch.randn(n, d, device=dev, generator=gen) / (math.log(2.0) + 1e-6)
    v = {"kernel_matvec_sym": torch.randn(n, 11, device=dev, generator=gen),
         "kernel_matvec": torch.randn(n, 65, device=dev, generator=gen)}
    calls = {"kernel_matvec_sym": lambda: rbf.kernel_matvec_sym(x, v["kernel_matvec_sym"]),
             "kernel_matvec": lambda: rbf.kernel_matvec(x, x, v["kernel_matvec"])}
    ref = {src: rbf.kernel_matvec_acc3_plain(x, x, v[src]) for src in VARIANTS}

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    times = {key: [] for key in libs}
    errs = {}
    for rnd in range(ROUNDS):
        for key, path in libs.items():
            src = key[0]
            _build.load(src, path)
            y = calls[src]()
            torch.cuda.synchronize()
            err = float((y - ref[src]).abs().max() / ref[src].abs().max())
            errs[key] = err if math.isfinite(err) else None
            times[key].append(cuda_ms(calls[src]))
            print(f"round {rnd} {src} {key[1]}: {times[key][-1]:.3f} ms, vs acc3 {err:.2e}", flush=True)
    print(json.dumps({f"{src} {name}": dict(ms=statistics.median(times[(src, name)]), err=errs[(src, name)],
                                            ptxas=registers(logs[(src, name)], src))
                      for src, name in libs}))


if __name__ == "__main__":
    main()
