"""PSD-safe Cholesky with escalating jitter (counterpart of
linear_operator_tpu/utils/cholesky.py).

Attempt a plain Cholesky; for the batch elements that fail, retry with
``jitter * 10**k`` added to the diagonal, k = 0 .. max_tries - 1.  Elements
that never factor hold NaN, the JAX package's contract.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .. import settings


@contextmanager
def highest_matmul_precision():
    """Run float32 matrix products in full float32 (no TF32) inside the
    block, whatever the process-wide setting; restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def psd_safe_cholesky(
    A: torch.Tensor,
    jitter: float | None = None,
    max_tries: int | None = None,
) -> torch.Tensor:
    """Lower Cholesky factor of ``A`` (*batch, n, n) with per-batch-element
    jitter retries; NaN where not factorizable."""
    if jitter is None:
        jitter = settings.cholesky_jitter.value(A.dtype)
    if max_tries is None:
        max_tries = settings.cholesky_max_tries.value()
    settings.record_linalg("psd_safe_cholesky", A.shape)

    L, info = torch.linalg.cholesky_ex(A)
    failed = info != 0
    if not bool(failed.any()):
        return L
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for k in range(max_tries):
        L_new, info_new = torch.linalg.cholesky_ex(A + (jitter * 10.0**k) * eye)
        take = failed & (info_new == 0)
        L = torch.where(take[..., None, None], L_new, L)
        failed = failed & ~take
        if not bool(failed.any()):
            return L
    return torch.where(failed[..., None, None], torch.full_like(L, float("nan")), L)
