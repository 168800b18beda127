"""The least time a kernel's work could take on one H100, from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM at its full 700 W, dense rates:
989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32 outside them,
3.35 TB/s of HBM3.

Basis: the fastest route that keeps a kernel mat-vec faithful to f32 is three
bf16 products with f32 accumulation (v split into bf16 hi and lo words,
K's entries likewise; lo x lo dropped), on the tensor cores; each entry's
formation (distance and exponent, 3d + 1 operations) runs in f32 beside
them.  The two run on different units, so the least time is the larger of
the formation at the f32 rate, the three products at the bf16 rate, and the
bytes read once and written once at the memory rate: no implementation can
take less, so no share reads above 100%.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(entries: float, products: float, d: int, nbytes: float) -> float:
    """``entries`` kernel entries formed, ``products`` flops an entry (two a
    column a product), ``nbytes`` read and written once."""
    form = entries * (3 * d + 1) / PEAK_F32_FLOPS
    mma = 3 * entries * products / PEAK_BF16_FLOPS
    return max(form, mma, nbytes / PEAK_BYTES_PER_S)


def k3_least_seconds(n: int, d: int, t: int) -> float:
    """K3, y = K v for the symmetric n x n kernel matrix and t columns: each
    of the n (n + 1) / 2 distinct entries formed once and used for its row
    and its column (4t flops); x and v read, y written."""
    return least_seconds(n * (n + 1) / 2, 4 * t, d, 4 * (n * d + 2 * n * t))


def k1_least_seconds(m: int, n: int, d: int, t: int) -> float:
    """K1, y = k(x1, x2) v for x1 (m, d), x2 (n, d), v (n, t): m n entries,
    2t flops each; x1, x2 and v read, y (m, t) written."""
    return least_seconds(m * n, 2 * t, d, 4 * (m * d + n * d + n * t + m * t))


def share_pct(least_s: float, device_s: float) -> float | None:
    """The least time as a per cent of the device time; None where the trace
    holds no such kernel."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s
