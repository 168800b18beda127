"""k1_roofline_pct.serve: K1's least time over its device time in the traced
serving window, in per cent.

K1 is ``matvec_kernel`` (csrc/kernel_matvec.cu; not ``sym_matvec_kernel``
or ``matvec_cached_kernel``), with the prepass kernels enqueued just before
each launch.  The work is what the queries asked for: for each batch of m
points, k(x*, x) times alpha (t = 1) and times the cache's root (t = its
columns) (roofline.py holds the least time of one)."""

import re

from benchmark.roofline import k1_least_seconds, share_pct

K1 = re.compile(r"(?<![A-Za-z_])matvec_kernel\b")


def read(trace):
    c = trace.counters
    if "batches" not in c:
        return None
    n, d, k = c["config"]["n"], c["config"]["d"], c["root_columns"]
    least = sum(k1_least_seconds(m, n, d, 1) + k1_least_seconds(m, n, d, k) for m in c["batches"])
    return share_pct(least, trace.kernel_seconds(K1))
