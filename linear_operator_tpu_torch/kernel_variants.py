"""Time variants of the hand-written kernels beside the kernels as built, on
one GPU.

    python3 -m linear_operator_tpu_torch.kernel_variants [source ...]

Each variant is a copy of a kernel's source (``csrc/kernel_matvec.cu``,
``kernel_matvec_sym.cu``, ``kernel_matvec_cached.cu``, ``kernel_weighted.cu``
or ``kernel_build_sym.cu``) with a textual change (:data:`VARIANTS`), compiled
with the package's nvcc flags into ``_build/variants/`` and loaded in place of
the built library.  At the main path's shapes (N = 100,000, d = 3, RBF; K3 at
t = 11, K1 at t = 65, K2 at t = 11 on (x, x, g, v), K5 on the tile-1024 cache
at t = 11 and t = 1, two passes, K4 building that cache) every library is
timed with CUDA events, in turns, and held against its kernel's plain version
in its own arithmetic (``kernel_matvec_acc3_plain``,
``kernel_weighted_acc3_plain`` on dx, ``rbf_matvec_sym_cached_plain``; K4's
tiles against ``rbf_build_sym_tiles_plain`` in bf16 ulps and the share of
entries not bit-identical).  Beside K4, a write-only pass over a tensor of the
cache's size (``fill_``) is timed once.  The variants say what holds each
kernel back ("wrong by design" ones are timed, not checked):

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
                 design);
  K5 no_mma      no products: the fragments are folded into the sums without
                 an mma (wrong by design), so the stream alone is timed;
  K5 no_staging  no copies of the tiles: the products run on whatever the
                 ring holds (wrong by design), so the compute alone is timed;
  K5 row_only    every sub-block treated as a diagonal one: no column half
                 (wrong by design);
  K5 no_atomic   the column sums are formed and turned around but not added
                 to y (wrong by design);
  K5 stages3     a ring of three stages instead of four;
  K2 no_mma      no products: g and v's fragments are folded into s without
                 an mma (wrong by design);
  K2 no_form     no distance and no k': w = s (wrong by design);
  K2 unroll2     the n8-block loop unrolled twice;
  K4 no_exp      the distance stored in place of k (wrong by design): no
                 covariance;
  K4 no_form     a constant stored in place of every entry (wrong by
                 design): no distance, no covariance, the stores alone;
  K4 no_store    every entry formed, no store issued (wrong by design):
                 the formation alone;
  K4 bulk_store  the store method not taken: each work item staged in
                 shared memory and written by the bulk-copy engine;
  K4 occupancy3  three CTAs an SM (launch bounds) in place of two;
  K4 rows128     work items of 128 x 128 in place of 16 x 1024;
  K4 ftz         2^y as one ex2.approx.ftz in place of (2^(y/2))^2:
                 subnormal entries flushed to 0 (timed; its tiles miss the
                 check at N = 1e5).

With source names (``kernel_build_sym kernel_matvec_cached
kernel_weighted``), only their variants are built and timed.  Prints the main-path instantiation's ptxas report of each library, one line
per library, call and round, then one JSON object of the medians.  Without a
CUDA device it fails at once.  ``tests/test_torch_kernels.py`` checks that
every variant still applies to its source.
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
    "kernel_matvec_cached": {
        "no_mma": [
            ("        mma_bf16(acc_t[nb], a, w.x, w.y);\n        if (passes == 2) mma_bf16(acc_t[nb], a, w.z, w.w);",
             "        acc_t[nb][0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ w.x ^ w.z);"),
            ("          mma_bf16(acc_c[nb], a, vr[kc][nb].hi[0], vr[kc][nb].hi[1]);\n"
             "          if (passes == 2) mma_bf16(acc_c[nb], a, vr[kc][nb].lo[0], vr[kc][nb].lo[1]);",
             "          acc_c[nb][0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ vr[kc][nb].hi[0] ^ vr[kc][nb].lo[1]);"),
        ],
        "no_staging": [("      cp_async16(dst + row * KPITCH + 16 * ch, src + static_cast<long long>(row) * tile + 8 * ch);",
                        "      if (row < 0) cp_async16(dst + row * KPITCH + 16 * ch, src + static_cast<long long>(row) * tile + 8 * ch);")],
        "row_only": [("    const bool diag = c / tb == r / tb;", "    const bool diag = true;")],
        "no_atomic": [("        if (col < n)\n          atomicAdd(", "        if (col < 0)\n          atomicAdd(")],
        "stages3": [("constexpr int NSTAGE = 4;", "constexpr int NSTAGE = 3;")],
    },
    "kernel_build_sym": {
        "no_exp": [("        for (int q = 0; q < CPT; ++q) e[q] = covar_fast<COVAR, false>(exact_d2<DS>(xr, xc[q]), alpha);",
                    "        for (int q = 0; q < CPT; ++q) e[q] = exact_d2<DS>(xr, xc[q]);")],
        "no_form": [("        for (int q = 0; q < CPT; ++q) e[q] = covar_fast<COVAR, false>(exact_d2<DS>(xr, xc[q]), alpha);",
                     "        for (int q = 0; q < CPT; ++q) e[q] = 0.5f;")],
        "no_store": [("{ st_global_cs(gbase", "{ if (alpha == 12345.0f) st_global_cs(gbase")],
        # each item into a 32 KiB staging buffer in shared memory,
        # double-buffered, handed to the bulk-copy engine (one copy of 32 KiB
        # when C = tile, else one per row, by R threads) while the next is
        # formed; a buffer's copies are waited on (wait_group.read) before it
        # is written again: one barrier per item
        "bulk_store": [
            ("constexpr int ITEM = 16384;                // entries of a work item, R x C\n",
             "constexpr int ITEM = 16384;                // entries of a work item, R x C\n"
             "constexpr int BUF_WORDS = ITEM / 8;        // uint4 of a staging buffer (32 KiB)\n"
             "__device__ __forceinline__ void fence_proxy_async() { asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\"); }\n"
             "__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, int bytes) {\n"
             "  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));\n"
             "  asm volatile(\"cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\" ::\"l\"(gmem), \"r\"(s), \"r\"(bytes)\n"
             "               : \"memory\");\n"
             "}\n"
             "__device__ __forceinline__ void bulk_commit() { asm volatile(\"cp.async.bulk.commit_group;\" ::: \"memory\"); }\n"
             "__device__ __forceinline__ void bulk_wait_read() { asm volatile(\"cp.async.bulk.wait_group.read 0;\" ::: \"memory\"); }\n"
             "__device__ __forceinline__ void bulk_wait() { asm volatile(\"cp.async.bulk.wait_group 0;\" ::: \"memory\"); }\n"),
            ("  constexpr int DP = DS == 8 ? 8 : 4;  // floats of a padded point (DS > 0)\n",
             "  constexpr int DP = DS == 8 ? 8 : 4;  // floats of a padded point (DS > 0)\n"
             "  extern __shared__ uint4 stage[];     // two staging buffers\n"),
            ("    // the word of row r, straight to the cache\n"
             "    auto emit = [&](int r, const uint4& w) { st_global_cs(gbase + static_cast<size_t>(r) * tile + c0, w); };",
             "    // the word of row r, into the staging buffer\n"
             "    uint4* buf = stage + ((p - p0) & 1) * BUF_WORDS;\n"
             "    auto emit = [&](int r, const uint4& w) { buf[r * groups + cg] = w; };"),
            ("    if (++blk == blocks) {",
             "    fence_proxy_async();\n"
             "    if (tid < rows) bulk_wait_read();\n"
             "    __syncthreads();\n"
             "    if (cols == tile) {\n"
             "      if (tid == 0) {\n"
             "        bulk_store(gbase, buf, ITEM * 2);\n"
             "        bulk_commit();\n"
             "      }\n"
             "    } else if (tid < rows) {\n"
             "      bulk_store(gbase + static_cast<size_t>(tid) * tile, buf + tid * groups, cols * 2);\n"
             "      bulk_commit();\n"
             "    }\n"
             "    if (++blk == blocks) {"),
            ("}\n\n// C, the columns of a work item", "  if (tid < rows) bulk_wait();\n}\n\n// C, the columns of a work item"),
            ("  cudaError_t err;\n",
             "  const size_t smem = 2 * BUF_WORDS * sizeof(uint4);\n"
             "  cudaError_t err =\n"
             "      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));\n"
             "  if (err != cudaSuccess) return err;\n"),
            ("(&per_sm, kern, NT, 0)", "(&per_sm, kern, NT, smem)"),
            ("kern<<<grid, NT, 0, stream>>>", "kern<<<grid, NT, smem, stream>>>"),
        ],
        "occupancy3": [("__launch_bounds__(NT, DS > 0 && DS <= 4 ? 2 : 1)", "__launch_bounds__(NT, DS > 0 && DS <= 4 ? 3 : 1)")],
        "rows128": [("  while (cols * 2 <= 1024 && tile % (cols * 2) == 0) cols *= 2;",
                     "  while (cols * 2 <= 128 && tile % (cols * 2) == 0) cols *= 2;")],
        "ftz": [("        for (int q = 0; q < CPT; ++q) e[q] = covar_fast<COVAR, false>(exact_d2<DS>(xr, xc[q]), alpha);",
                 "        for (int q = 0; q < CPT; ++q) e[q] = covar_fast<COVAR, true>(exact_d2<DS>(xr, xc[q]), alpha);")],
    },
    "kernel_weighted": {
        "no_mma": [("        for (int mb = 0; mb < MB; ++mb) acc3(s[mb], ga[mb][ks], vf);",
                    "        for (int mb = 0; mb < MB; ++mb) {\n"
                    "          s[mb][0] += __uint_as_float(ga[mb][ks].hi[0] ^ ga[mb][ks].lo[1] ^ vf.hi[0]) * 1e-30f;\n"
                    "          s[mb][1] += __uint_as_float(ga[mb][ks].hi[1] ^ ga[mb][ks].lo[2] ^ vf.hi[1]) * 1e-30f;\n"
                    "          s[mb][2] += __uint_as_float(ga[mb][ks].hi[2] ^ ga[mb][ks].lo[3] ^ vf.lo[0]) * 1e-30f;\n"
                    "          s[mb][3] += __uint_as_float(ga[mb][ks].hi[3] ^ ga[mb][ks].lo[0] ^ vf.lo[1]) * 1e-30f;\n"
                    "        }")],
        "no_form": [("            const float w = dcovar_fast<COVAR>(d2[r][c], alpha) * s[mb][2 * r + c];",
                     "            const float w = s[mb][2 * r + c];")],
        "unroll2": [("#pragma unroll 1\n    for (int nb", "#pragma unroll 2\n    for (int nb")],
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

    sources = sys.argv[1:] or list(VARIANTS)
    if not set(sources) <= set(VARIANTS):
        print(f"FAIL: sources are among {sorted(VARIANTS)}, got {sources}", file=sys.stderr, flush=True)
        sys.exit(1)
    # the libraries as built, then one patched copy of the source per variant,
    # all compiled at once
    _build.build(sources)
    libs = {(src, "built"): _build.library_path(src) for src in sources}
    logs = {key: path.with_suffix(".log").read_text() for key, path in libs.items()}
    work = _build.BUILD_DIR / "variants"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    procs = {}
    for src in sources:
        for name in VARIANTS[src]:
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
    v11, v65, g11, v1 = (torch.randn(n, t, device=dev, generator=gen) for t in (11, 65, 11, 1))

    def dx(out):
        wx, ws = out
        return 2.0 * (ws[:, None] * x - wx)

    def rel(ref, out=lambda y: y):
        """Its output's largest difference from the plain version's, relative
        to the plain version's largest entry."""
        def err(y):
            e = float((out(y) - ref).abs().max() / ref.abs().max())
            return e if math.isfinite(e) else None
        return err

    def tile_err(ref):
        """K4's tiles against the plain version's: the largest difference in
        bf16 ulps and the share of entries not bit-identical."""
        def err(y):
            ulp, differ = 0, 0
            for s in range(0, y.shape[0], 256):
                diff = (y[s : s + 256].view(torch.int16).int() - ref[s : s + 256].view(torch.int16).int()).abs()
                ulp, differ = max(ulp, int(diff.max())), differ + int((diff != 0).sum())
            return dict(ulp=ulp, differ=differ / y.numel())
        return err

    # source -> [(label, call, its error against the plain version)]
    def k5_calls():
        # the cache the K5 calls read: built by K4 as built (9.47 GiB)
        tiles = rbf.rbf_build_sym_tiles(x, 1024)
        return [(f"t={v.shape[1]}", (lambda v=v: rbf.rbf_matvec_sym_cached(tiles, v, n, 1024)),
                 rel(rbf.rbf_matvec_sym_cached_plain(tiles, v, n, 1024))) for v in (v11, v1)]

    def k4_calls():
        ref = rbf.rbf_build_sym_tiles_plain(x, 1024)
        # a reference for the byte bound: a write-only pass over a tensor of the
        # cache's size, the rate the card writes these bytes at
        print(f"write-only pass over the cache (fill_, {2 * ref.numel() / 1e9:.3f} GB): "
              f"{cuda_ms(lambda: torch.empty_like(ref).fill_(0)):.3f} ms", flush=True)
        return [("N=1e5 tile=1024", lambda: rbf.rbf_build_sym_tiles(x, 1024), tile_err(ref))]

    calls = {
        "kernel_matvec_sym": lambda: [("t=11", lambda: rbf.kernel_matvec_sym(x, v11),
                                       rel(rbf.kernel_matvec_acc3_plain(x, x, v11)))],
        "kernel_matvec": lambda: [("t=65", lambda: rbf.kernel_matvec(x, x, v65),
                                   rel(rbf.kernel_matvec_acc3_plain(x, x, v65)))],
        "kernel_weighted": lambda: [("t=11", lambda: rbf.kernel_weighted(x, x, g11, v11),
                                     rel(dx(rbf.kernel_weighted_acc3_plain(x, x, g11, v11)), dx))],
        "kernel_matvec_cached": k5_calls,
        "kernel_build_sym": k4_calls,
    }

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

    calls = {src: calls[src]() for src in sources}
    times = {(key, label): [] for key in libs for label, *_ in calls[key[0]]}
    errs = {}
    for rnd in range(ROUNDS):
        for key, path in libs.items():
            src = key[0]
            _build.load(src, path)
            for label, call, err_fn in calls[src]:
                err = errs[(key, label)] = err_fn(call())
                times[(key, label)].append(cuda_ms(call))
                print(f"round {rnd} {src} {key[1]} {label}: {times[(key, label)][-1]:.3f} ms, vs plain {err}",
                      flush=True)
    print(json.dumps({f"{src} {name} {label}": dict(ms=statistics.median(ts), err=errs[((src, name), label)],
                                                    ptxas=registers(logs[(src, name)], src))
                      for ((src, name), label), ts in times.items()}))


if __name__ == "__main__":
    main()
