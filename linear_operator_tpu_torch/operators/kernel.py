"""Lazy kernel matrices K[i, j] = k(x1_i, x2_j; params), never materialized
at scale (counterpart of linear_operator_tpu/operators/kernel.py).

``_matmul`` evaluates K in row blocks of ``block_rows`` through the plain
``covar_func``, or, when ``matvec_impl`` is set, through the fused CUDA
kernels of ``ops/rbf.py`` (:func:`fused_covar_matvec`), which never form a
kernel block in device memory.  ``_bilinear_derivative`` follows: one sweep
of blocks, each differentiated inside the sweep, or autograd through the
fused kernels, whose backward is K2.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .. import settings
from ..ops.rbf import (
    TILE_COVARS,
    kernel_matvec,
    kernel_matvec_sym,
    sq_dist as _sq_dist,
    sym_matvec_supported,
)
from ..utils.broadcasting import broadcast_shapes
from ..utils.cholesky import highest_matmul_precision
from ._linear_operator import LinearOperator


class KernelLinearOperator(LinearOperator):
    def __init__(
        self,
        x1: torch.Tensor,  # (*b, n, d)
        x2: torch.Tensor,  # (*b, m, d)
        params: dict,  # name -> hyperparameter tensor
        covar_func: Callable,
        block_rows: int = 4096,
        symmetric: bool = False,
        matvec_impl: Callable | None = None,
        materialize_threshold: int | None = 2**30,
    ):
        self.x1 = x1
        self.x2 = x2
        self.params = params
        self.covar_func = covar_func
        self.block_rows = block_rows
        self.symmetric = symmetric
        # matvec_impl(x1, x2, rhs, params, symmetric=...) -> K @ rhs, a fused
        # mat-vec that forms no kernel block in memory
        self.matvec_impl = matvec_impl
        # byte budget of the per-solve dense f32 K cache (_matmul_closure);
        # None disables it
        self.materialize_threshold = materialize_threshold

    def _shape(self) -> tuple[int, ...]:
        # a hyperparameter's dims beyond its last two are batch dims
        param_batches = [tuple(p.shape[: max(0, p.ndim - 2)]) for p in self.params.values()]
        batch = broadcast_shapes(self.x1.shape[:-2], self.x2.shape[:-2], *param_batches)
        return (*batch, self.x1.shape[-2], self.x2.shape[-2])

    def _transpose(self) -> "KernelLinearOperator":
        return self._replace(x1=self.x2, x2=self.x1)

    def _matmul_closure(self):
        """Per-solve K cache: when the f32 kernel matrix fits
        ``materialize_threshold`` bytes, form it once and let every solver
        iteration multiply by it; otherwise every iteration re-forms K
        (streamed by ``_matmul``).  ``settings.memory_efficient`` turns the
        cache off."""
        if settings.memory_efficient.on():
            return self._matmul
        thr = self.materialize_threshold
        if thr is not None and math.prod(self.shape) * 4 <= thr:
            kd = self.to_dense().to(torch.float32)

            def cached_mm(rhs: torch.Tensor) -> torch.Tensor:
                with highest_matmul_precision():
                    return torch.matmul(kd, rhs.to(torch.float32)).to(rhs.dtype)

            return cached_mm
        return self._matmul

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        if self.matvec_impl is not None:
            return self.matvec_impl(self.x1, self.x2, rhs, self.params, symmetric=self.symmetric)
        n = self.x1.shape[-2]
        out = []
        # f32 contractions in full f32: a TF32 K-block product would inject
        # ~1e-3 relative noise into every mat-vec and stall CG
        with highest_matmul_precision():
            for start in range(0, n, self.block_rows):
                kb = self.covar_func(self.x1[..., start : start + self.block_rows, :], self.x2, **self.params)
                out.append(torch.matmul(kb, rhs))
        return torch.cat(out, dim=-2)

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """One-sweep blocked backward: each row block of K is formed, and its
        gradient taken, inside the sweep, so that only one block's autograd
        residuals are alive at a time (autograd through the blocked
        ``_matmul`` would keep every block: at n = 1e5 the 40 GB kernel
        matrix several times over).  The fused path and a single block take
        the base path; there autograd runs through ``fused_covar_matvec``
        into the kernels' own backward (K2)."""
        n = self.x1.shape[-2]
        if self.matvec_impl is not None or n <= self.block_rows:
            return super()._bilinear_derivative(left_vecs, right_vecs)
        names = [k for k, v in self.params.items() if isinstance(v, torch.Tensor)]
        leaves = [self.x1, self.x2, *(self.params[k] for k in names)]  # _leaves() order
        needs = [t.requires_grad for t in leaves]
        if not any(needs):
            return (None,) * len(leaves)
        sums = [None] * len(leaves)  # x2 and the params: summed over blocks
        dx1 = []
        with torch.enable_grad():
            x2, *pvals = (t.detach().requires_grad_(r) for t, r in zip(leaves[1:], needs[1:]))
            params = {**self.params, **dict(zip(names, pvals))}
            for start in range(0, n, self.block_rows):
                rows = slice(start, start + self.block_rows)
                x1b = self.x1[..., rows, :].detach().requires_grad_(needs[0])
                inputs = [x1b, x2, *pvals]
                with highest_matmul_precision():
                    kb = self.covar_func(x1b, x2, **params)
                    f = torch.sum(left_vecs[..., rows, :] * torch.matmul(kb, right_vecs))
                wanted = [t for t, r in zip(inputs, needs) if r]
                it = iter(torch.autograd.grad(f, wanted, allow_unused=True))
                grads = [next(it) if r else None for r in needs]
                dx1.append(grads[0])
                for k in range(1, len(leaves)):
                    if grads[k] is not None:
                        sums[k] = grads[k] if sums[k] is None else sums[k] + grads[k]
        if needs[0]:
            sums[0] = torch.cat(dx1, dim=-2)
        return tuple(sums)

    def _diagonal(self) -> torch.Tensor:
        # n shoved into a batch dim: the covariance of each point with itself
        vals = self.covar_func(self.x1[..., :, None, :], self.x2[..., :, None, :], **self.params)
        return vals[..., 0, 0]

    def to_dense(self) -> torch.Tensor:
        return self.covar_func(self.x1, self.x2, **self.params)

    def _select_cols(self, idx) -> "KernelLinearOperator":
        """K[..., :, idx] stays a lazy kernel operator on the gathered points,
        on the blocked path (the fused kernels take whole operators only)."""
        return self._replace(x2=self.x2[..., idx, :], symmetric=False, matvec_impl=None)


# ---------------------------------------------------------------------------
# Standard covariances
# ---------------------------------------------------------------------------


def rbf_covar(x1, x2, lengthscale, outputscale):
    """outputscale * exp(-|x1 - x2|^2 / (2 l^2))."""
    return outputscale * TILE_COVARS["rbf"].fn(_sq_dist(x1 / lengthscale, x2 / lengthscale))


def matern52_covar(x1, x2, lengthscale, outputscale):
    return outputscale * TILE_COVARS["matern52"].fn(_sq_dist(x1 / lengthscale, x2 / lengthscale))


def matern32_covar(x1, x2, lengthscale, outputscale):
    return outputscale * TILE_COVARS["matern32"].fn(_sq_dist(x1 / lengthscale, x2 / lengthscale))


def matern12_covar(x1, x2, lengthscale, outputscale):
    """Exponential (Matern nu = 1/2): outputscale * exp(-|x1 - x2| / l)."""
    return outputscale * TILE_COVARS["matern12"].fn(_sq_dist(x1 / lengthscale, x2 / lengthscale))


def rq_covar(x1, x2, lengthscale, outputscale, alpha):
    """Rational quadratic: outputscale * (1 + d2 / (2 alpha))^-alpha."""
    d2 = _sq_dist(x1 / lengthscale, x2 / lengthscale)
    return outputscale * (1.0 + d2 / (2.0 * alpha)) ** (-alpha)


# ---------------------------------------------------------------------------
# Fused dispatch
# ---------------------------------------------------------------------------


def fused_covar_matvec(covar: str, x1, x2, rhs, params, *, symmetric: bool = False):
    """Fused stationary-kernel mat-vec through the kernels of ops/rbf.py
    (the JAX package's ``_pallas_covar_matvec``).

    The lengthscale prescale and the outputscale multiply stay here, in
    PyTorch; the kernels take f32.  A symmetric operator with a narrow rhs
    (``sym_matvec_supported``) takes K3, which forms each off-diagonal tile
    once; everything else, the posterior's wide solve included, takes K1.
    Batch dims are broadcast and flattened into the kernels' grid."""
    ls = params["lengthscale"]
    x1s = (x1 / ls).to(torch.float32)
    x2s = (x2 / ls).to(torch.float32)
    v = rhs.to(torch.float32)
    batch = broadcast_shapes(x1s.shape[:-2], x2s.shape[:-2], v.shape[:-2])

    def flat(a):
        return a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:]).contiguous()

    if symmetric and x1.shape[-2] == x2.shape[-2] and sym_matvec_supported(v.shape[-1]):
        out = kernel_matvec_sym(flat(x1s), flat(v), covar)
    else:
        out = kernel_matvec(flat(x1s), flat(x2s), flat(v), covar)
    out = out.reshape(*batch, *out.shape[-2:])
    return (params["outputscale"] * out).to(rhs.dtype)


def rbf_fused_matvec(x1, x2, rhs, params, *, symmetric: bool = False):
    return fused_covar_matvec("rbf", x1, x2, rhs, params, symmetric=symmetric)


def rbf_kernel_operator(
    x1, x2=None, *, lengthscale, outputscale, block_rows: int = 4096,
    use_fused_kernels: bool = True, materialize_threshold: int | None = 2**30,
) -> KernelLinearOperator:
    """RBF kernel operator; ``use_fused_kernels`` routes its mat-vecs through
    the CUDA kernels (their plain versions for CPU tensors)."""
    return KernelLinearOperator(
        x1,
        x1 if x2 is None else x2,
        {
            "lengthscale": torch.as_tensor(lengthscale, dtype=x1.dtype, device=x1.device),
            "outputscale": torch.as_tensor(outputscale, dtype=x1.dtype, device=x1.device),
        },
        covar_func=rbf_covar,
        block_rows=block_rows,
        symmetric=x2 is None,
        matvec_impl=rbf_fused_matvec if use_fused_kernels else None,
        materialize_threshold=materialize_threshold,
    )
