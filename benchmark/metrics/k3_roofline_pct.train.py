"""k3_roofline_pct.train: K3's least time over its device time in the traced
training window, in per cent.

K3 is ``sym_matvec_kernel`` (csrc/kernel_matvec_sym.cu), with the prepass
kernels enqueued just before each launch (``pad_points_kernel``,
``split_v_kernel``).  The work is what the solver asked for: a product
with the n x n kernel matrix at t = probes + 1 columns for every CG
iteration, and one more a step for the backward's bilinear form
(roofline.py holds the least time of one)."""

import re

from benchmark.roofline import k3_least_seconds, share_pct

K3 = re.compile(r"\bsym_matvec_kernel\b")


def read(trace):
    c = trace.counters
    if "cg_iters" not in c or not c["cg_iters"]:
        return None
    cfg = c["config"]
    t = cfg["settings"]["num_trace_samples"] + 1
    products = sum(c["cg_iters"]) + c["steps"]
    return share_pct(products * k3_least_seconds(cfg["n"], cfg["d"], t), trace.kernel_seconds(K3))
