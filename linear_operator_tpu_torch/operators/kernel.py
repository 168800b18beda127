"""Lazy kernel matrices K[i, j] = k(x1_i, x2_j; params), never materialized
at scale (counterpart of linear_operator_tpu/operators/kernel.py).

``_matmul`` evaluates K in row blocks of ``block_rows`` through the plain
``covar_func``, or, when ``matvec_impl`` is set, through the fused CUDA
kernels of ``ops/rbf.py`` (:func:`fused_covar_matvec`), which never form a
kernel block in device memory.  ``_bilinear_derivative`` follows: one sweep
of blocks, each differentiated inside the sweep, or autograd through the
fused kernels, whose backward is K2.  ``_matmul_closure`` is the per-solve
cache: a ``matvec_closure_impl`` (:func:`rbf_fused_closure`, the bf16 tile
cache of K4 and K5) if one applies, else the dense f32 matrix if it fits,
else streaming.
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
    rbf_build_sym_tiles,
    rbf_matvec_sym_cached,
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
        matvec_closure_impl: Callable | None = None,
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
        # matvec_closure_impl(x1, x2, params, symmetric) -> closure or None: a
        # per-solve closure builder (rbf_fused_closure builds the bf16 tile
        # cache once and streams it every iteration); None falls through to
        # the dense f32 cache and streaming
        self.matvec_closure_impl = matvec_closure_impl

    def _batch_shape(self) -> tuple[int, ...]:
        # a hyperparameter's dims beyond its last two are batch dims
        param_batches = [tuple(p.shape[: max(0, p.ndim - 2)]) for p in self.params.values()]
        return broadcast_shapes(self.x1.shape[:-2], self.x2.shape[:-2], *param_batches)

    def _shape(self) -> tuple[int, ...]:
        return (*self._batch_shape(), self.x1.shape[-2], self.x2.shape[-2])

    def _transpose(self) -> "KernelLinearOperator":
        return self._replace(x1=self.x2, x2=self.x1)

    def _matmul_closure(self):
        """Per-solve K cache.  A ``matvec_closure_impl`` goes first (it gates
        itself, and returns None where it does not apply); then, when the f32
        kernel matrix fits ``materialize_threshold`` bytes, it is formed once
        and every solver iteration multiplies by it; otherwise every iteration
        re-forms K (streamed by ``_matmul``).  ``settings.memory_efficient``
        turns both caches off."""
        if settings.memory_efficient.on():
            return self._matmul
        if self.matvec_closure_impl is not None:
            closure = self.matvec_closure_impl(self.x1, self.x2, self.params, self.symmetric)
            if closure is not None:
                return closure
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
        # n shoved into a batch dim: the covariance of each point with itself;
        # a batched hyperparameter gains the n singleton before its last two dims
        params = {k: v.unsqueeze(-3) if v.ndim > 2 else v for k, v in self.params.items()}
        vals = self.covar_func(self.x1[..., :, None, :], self.x2[..., :, None, :], **params)
        return vals[..., 0, 0]

    def to_dense(self) -> torch.Tensor:
        return self.covar_func(self.x1, self.x2, **self.params)

    def _index_param(self, val: torch.Tensor, batch_indices) -> torch.Tensor:
        """val[*batch_indices, ...] with the hyperparameter broadcast to the
        operator's batch shape first; its last two dims (or fewer) are not
        batch dims and stay whole."""
        if not batch_indices:
            return val
        nonbatch = tuple(val.shape[max(0, val.ndim - 2) :])
        val = val.expand(*self._batch_shape(), *nonbatch)
        return val[(*batch_indices, *([slice(None)] * len(nonbatch)))]

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """k(x1[i], x2[j]) elementwise over broadcast index tensors: the
        pointwise evaluation pivoted Cholesky gathers its columns with."""
        x1, x2 = self.x1, self.x2
        if batch_indices:
            batch = self._batch_shape()
            x1 = x1.expand(*batch, *x1.shape[-2:])
            x2 = x2.expand(*batch, *x2.shape[-2:])
        x1 = x1[(*batch_indices, row_index, slice(None))]  # (*idx, d)
        x2 = x2[(*batch_indices, col_index, slice(None))]
        params = {name: self._index_param(val, batch_indices) for name, val in self.params.items()}
        return self.covar_func(x1[..., None, :], x2[..., None, :], **params)[..., 0, 0]

    def _select_cols(self, idx) -> "KernelLinearOperator":
        """K[..., :, idx] stays a lazy kernel operator on the gathered points,
        on the blocked path (the fused kernels and the per-solve closure
        builder take whole operators only)."""
        return self._replace(
            x2=self.x2[..., idx, :], symmetric=False, matvec_impl=None, matvec_closure_impl=None
        )


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


# Device-memory budget of the bf16 upper-triangle tile cache; tiles are
# (tile, tile) bf16.  Below _RBF_CACHE_MIN_N points the dense f32 cache serves.
RBF_TILE_CACHE_BUDGET = 11 * 2**30
_RBF_TILE = 1024
_RBF_CACHE_MIN_N = 24_576


def _tile_cache_device(x: torch.Tensor) -> bool:
    """Whether K4 and K5 can run on x: it lies on a CUDA device."""
    return x.device.type == "cuda"


def rbf_fused_closure(x1, x2, params, symmetric: bool):
    """Per-solve closure builder for large symmetric RBF kernels (the JAX
    package's ``rbf_pallas_closure``): K4 builds the bf16 upper-triangle tile
    cache once (one exp sweep over n^2 / 2 entries), and every CG or Lanczos
    iteration then streams the stored tiles through K5.

    Opt-in, as in the JAX package: the cached operator is bf16(K), whose
    elementwise rounding has a spectral norm of about 2 * 2^-9 * rms(K) *
    sqrt(n) (~0.16 at n = 1e5 and the default lengthscale).  Where that
    exceeds the noise diagonal, bf16(K) + D is indefinite and CG diverges; the
    cache serves noise floors well above it (sigma^2 = 1 at n = 1e5).

    Returns None (the caller falls back to the dense cache or streaming) when
    the operator is not symmetric or is batched, when n < _RBF_CACHE_MIN_N,
    when the cache would exceed RBF_TILE_CACHE_BUDGET, or when the kernels
    cannot run: x1 is not on a CUDA device (the port's counterpart of the JAX
    package's ``_use_interpret()``).  The JAX package also declines under a
    device mesh; that gate waits for the port's ``parallel/``.

    x is detached before K4 (the JAX package's ``stop_gradient``), so
    gradients flow through the operator's ``_bilinear_derivative`` (K2 and
    K3).  A batched or wider than 16-column rhs streams through
    :func:`rbf_fused_matvec` instead."""
    n = x1.shape[-2]
    if not symmetric or x1.ndim != 2 or n < _RBF_CACHE_MIN_N:
        return None
    if not _tile_cache_device(x1):
        return None
    nblk = -(-n // _RBF_TILE)
    if nblk * (nblk + 1) // 2 * _RBF_TILE * _RBF_TILE * 2 > RBF_TILE_CACHE_BUDGET:
        return None

    xs = (x1 / params["lengthscale"]).to(torch.float32).detach().contiguous()
    tiles = rbf_build_sym_tiles(xs, _RBF_TILE)

    def closure(rhs: torch.Tensor) -> torch.Tensor:
        if rhs.ndim != 2 or not sym_matvec_supported(rhs.shape[-1]):
            return rbf_fused_matvec(x1, x2, rhs, params, symmetric=symmetric)
        out = rbf_matvec_sym_cached(tiles, rhs.to(torch.float32).contiguous(), n, _RBF_TILE, passes=2)
        return (params["outputscale"] * out).to(rhs.dtype)

    return closure


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
