"""PSD-safe Cholesky with escalating jitter (counterpart of
linear_operator_tpu/utils/cholesky.py).

Attempt a plain Cholesky; for the batch elements that fail, retry with
``jitter * 10**k`` added to the diagonal, k = 0 .. max_tries - 1.  Elements
that never factor hold NaN, the JAX package's contract.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

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


def blocked_cholesky(A: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Lower Cholesky factor by a right-looking blocked sweep: for each
    block column i, L_ii = chol(A_ii - L_i: L_i:^T) and L_ji = (A_ji -
    L_j: L_i:^T) L_ii^{-T}, the trailing products in full f32.  NaN
    propagates from a block that is not positive definite, as
    ``torch.linalg.cholesky_ex`` reports it; n not a multiple of ``block``
    is padded with an identity tail.  Differentiable."""
    n = A.shape[-1]
    if n <= block:
        L, info = torch.linalg.cholesky_ex(A)
        return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
    nb = -(-n // block)
    npad = nb * block - n
    if npad:
        A = torch.nn.functional.pad(A, (0, npad, 0, npad))
        tail = torch.zeros(n + npad, dtype=A.dtype, device=A.device)
        tail[n:] = 1.0
        A = A + torch.diag(tail)
    cols = []  # the factor's block columns below the diagonal, (*b, N - s, block)
    with highest_matmul_precision():
        for i in range(nb):
            s = i * block
            a = A[..., s:, s : s + block]
            for c, col in enumerate(cols):
                # block column c's rows from s on, against its rows s .. s + block
                lc = col[..., s - c * block :, :]
                a = a - lc @ lc[..., :block, :].mT
            lii, info = torch.linalg.cholesky_ex(a[..., :block, :])
            lii = torch.where((info != 0)[..., None, None], torch.full_like(lii, float("nan")), lii)
            panel = torch.linalg.solve_triangular(lii, a[..., block:, :].mT, upper=False).mT
            cols.append(torch.cat([lii, panel], dim=-2))
    rows = [torch.nn.functional.pad(col, (0, 0, c * block, 0)) for c, col in enumerate(cols)]
    out = torch.cat(rows, dim=-1)
    return out[..., :n, :n] if npad else out


class CholeskyResult(NamedTuple):
    factor: torch.Tensor  # lower triangular, NaN where the factorization failed
    ok: torch.Tensor  # bool (*batch,): the factorization succeeded
    jitter: torch.Tensor  # (*batch,): the jitter finally added to the diagonal


def psd_safe_cholesky_ex(
    A: torch.Tensor,
    jitter: float | None = None,
    max_tries: int | None = None,
) -> CholeskyResult:
    """:func:`psd_safe_cholesky` with what it did: the factor, which batch
    elements factored, and the jitter each one took."""
    if jitter is None:
        jitter = settings.cholesky_jitter.value(A.dtype)
    if max_tries is None:
        max_tries = settings.cholesky_max_tries.value()
    settings.record_linalg("psd_safe_cholesky", A.shape)
    L, info = torch.linalg.cholesky_ex(A)
    ok = info == 0
    applied = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    if bool(ok.all()):
        return CholeskyResult(L, ok, applied)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for k in range(max_tries):
        jit = jitter * 10.0**k
        L_new, info_new = torch.linalg.cholesky_ex(A + jit * eye)
        take = ~ok & (info_new == 0)
        L = torch.where(take[..., None, None], L_new, L)
        applied = torch.where(take, torch.full_like(applied, jit), applied)
        ok = ok | take
        if bool(ok.all()):
            return CholeskyResult(L, ok, applied)
    return CholeskyResult(torch.where(ok[..., None, None], L, torch.full_like(L, float("nan"))), ok, applied)


class _PsdSafeCholesky(torch.autograd.Function):
    """The JAX package's custom VJP: the retries run outside autograd, and the
    gradient is that of cholesky(A + jitter I), the jitter finally applied
    held constant (Murray 2016: L^-H Phi(L^H dL) L^-1, Phi the lower triangle
    with half its diagonal, made symmetric).  A failed attempt's factor, which
    holds NaN on the card, never enters it."""

    @staticmethod
    def forward(ctx, A, jitter, max_tries):
        L = psd_safe_cholesky_ex(A, jitter, max_tries).factor
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        (L,) = ctx.saved_tensors
        gA = (L.mH @ gL).tril()
        gA = 0.5 * (gA + gA.tril(-1).mH)
        gA = torch.linalg.solve_triangular(L.mH, gA, upper=True, left=True)
        return torch.linalg.solve_triangular(L, gA, upper=False, left=False), None, None


def psd_safe_cholesky(
    A: torch.Tensor,
    jitter: float | None = None,
    max_tries: int | None = None,
) -> torch.Tensor:
    """Lower Cholesky factor of ``A`` (*batch, n, n) with per-batch-element
    jitter retries; NaN where not factorizable.  Differentiable: the gradient
    is cholesky(A + jitter I)'s, with the jitter each element took."""
    return _PsdSafeCholesky.apply(A, jitter, max_tries)
