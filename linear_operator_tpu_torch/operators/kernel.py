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

The covariances: RBF, Matern (nu 1/2, 3/2, 5/2) and the rational quadratic,
whose operators take the fused kernels, and the periodic and spectral
mixture kernels, which take the blocked engine only.  A covariance may
return a LinearOperator; the layout fields (``num_outputs_per_input``,
``nonbatch_dims``, ``static_params``) carry multi-output kernels and
hyperparameters with batch dims.
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
    rq_tile_covar,
    sq_dist as _sq_dist,
    sym_matvec_supported,
)
from ..utils.broadcasting import broadcast_shapes
from ..utils.cholesky import highest_matmul_precision
from ._linear_operator import LinearOperator


def _covar_matmul(kb, rhs: torch.Tensor) -> torch.Tensor:
    """A kernel block @ rhs, where the covariance returned a dense tensor or
    a LinearOperator; full f32 products either way."""
    with highest_matmul_precision():
        return kb.matmul(rhs) if isinstance(kb, LinearOperator) else torch.matmul(kb, rhs)


def _covar_dense(kb) -> torch.Tensor:
    return kb.to_dense() if isinstance(kb, LinearOperator) else kb


class KernelLinearOperator(LinearOperator):
    """K[i, j] = covar_func(x1_i, x2_j, **params, **static_params).

    ``covar_func`` returns a dense block or a LinearOperator.  The layout
    fields follow the JAX package: ``num_outputs_per_input`` (t1, t2) makes
    each x1 point t1 rows and each x2 point t2 columns (multi-output
    kernels); ``nonbatch_dims``, as ``(("name", k), ...)``, says that a
    hyperparameter's last k dims are not batch dims (2 for a name not
    listed), its leading ones broadcasting into the operator's batch shape;
    ``static_params``, as ``(("name", value), ...)``, are covariance
    arguments that are not tensors."""

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
        num_outputs_per_input: tuple = (1, 1),
        nonbatch_dims: tuple | None = None,
        static_params: tuple = (),
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
        self.num_outputs_per_input = tuple(num_outputs_per_input)
        self.nonbatch_dims = nonbatch_dims
        self.static_params = tuple(static_params)

    @property
    def tensor_params(self) -> dict:
        """The differentiable hyperparameters."""
        return self.params

    @property
    def nontensor_params(self) -> dict:
        """The covariance's arguments that are not tensors."""
        return dict(self.static_params)

    def _all_params(self) -> dict:
        return {**self.params, **dict(self.static_params)}

    def _nonbatch(self, name: str) -> int:
        for key, k in self.nonbatch_dims or ():
            if key == name:
                return k
        return 2

    def _param_batch_shapes(self) -> list[tuple[int, ...]]:
        shapes = []
        for name, val in self.params.items():
            k = self._nonbatch(name)
            shape = tuple(val.shape)
            shapes.append(shape[: max(0, len(shape) - k)] if k else shape)
        return shapes

    def _batch_shape(self) -> tuple[int, ...]:
        return broadcast_shapes(self.x1.shape[:-2], self.x2.shape[:-2], *self._param_batch_shapes())

    def _shape(self) -> tuple[int, ...]:
        t1, t2 = self.num_outputs_per_input
        return (*self._batch_shape(), self.x1.shape[-2] * t1, self.x2.shape[-2] * t2)

    @property
    def covar_mat(self):
        """``covar_func(x1, x2, **params)``: a dense tensor or a LinearOperator."""
        return self.covar_func(self.x1, self.x2, **self._all_params())

    def _transpose(self) -> "KernelLinearOperator":
        t1, t2 = self.num_outputs_per_input
        return self._replace(x1=self.x2, x2=self.x1, num_outputs_per_input=(t2, t1))

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
        params = self._all_params()
        n = self.x1.shape[-2]
        out = []
        # f32 contractions in full f32: a TF32 K-block product would inject
        # ~1e-3 relative noise into every mat-vec and stall CG
        with highest_matmul_precision():
            for start in range(0, n, self.block_rows):
                kb = self.covar_func(self.x1[..., start : start + self.block_rows, :], self.x2, **params)
                out.append(_covar_matmul(kb, rhs))
        return torch.cat(out, dim=-2)

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """One-sweep blocked backward: each row block of K (t1 rows a point)
        is formed, and its gradient taken, inside the sweep, so that only one
        block's autograd residuals are alive at a time (autograd through the
        blocked ``_matmul`` would keep every block: at n = 1e5 the 40 GB
        kernel matrix several times over).  The fused path and a single
        block take the base path; there autograd runs through
        ``fused_covar_matvec`` into the kernels' own backward (K2)."""
        t1 = self.num_outputs_per_input[0]
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
        statics = dict(self.static_params)
        with torch.enable_grad():
            x2, *pvals = (t.detach().requires_grad_(r) for t, r in zip(leaves[1:], needs[1:]))
            params = {**self.params, **dict(zip(names, pvals)), **statics}
            for start in range(0, n, self.block_rows):
                x1b = self.x1[..., start : start + self.block_rows, :].detach().requires_grad_(needs[0])
                inputs = [x1b, x2, *pvals]
                rows = slice(start * t1, (start + x1b.shape[-2]) * t1)
                with highest_matmul_precision():
                    kb = self.covar_func(x1b, x2, **params)
                f = torch.sum(left_vecs[..., rows, :] * _covar_matmul(kb, right_vecs))
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

    def _per_point_blocks(self, k: int) -> torch.Tensor:
        """(*b, k, t1, t2): the covariance of each of the first k points of
        x1 with the same point of x2, n shoved into a batch dim; a batched
        hyperparameter gains the n singleton before its non-batch dims."""
        params = {}
        for name, val in self.params.items():
            nb = self._nonbatch(name)
            params[name] = val.unsqueeze(-(nb + 1)) if val.ndim > nb else val
        vals = self.covar_func(
            self.x1[..., :k, None, :], self.x2[..., :k, None, :], **params, **dict(self.static_params)
        )
        return _covar_dense(vals)

    def _diagonal(self) -> torch.Tensor:
        t1, t2 = self.num_outputs_per_input
        if t1 != t2:
            return super()._diagonal()
        # a rectangular sub-operator's diagonal has min(n, m) points' blocks
        vals = self._per_point_blocks(min(self.x1.shape[-2], self.x2.shape[-2]))
        if t1 == 1:
            return vals[..., 0, 0]
        d = torch.diagonal(vals, dim1=-2, dim2=-1)  # (*b, k, t)
        return d.reshape(*d.shape[:-2], -1)

    def to_dense(self) -> torch.Tensor:
        return _covar_dense(self.covar_mat)

    def _covar_mat_operator(self) -> LinearOperator:
        from .dense import DenseLinearOperator

        mat = self.covar_mat
        return mat if isinstance(mat, LinearOperator) else DenseLinearOperator(mat)

    def _broadcast_data(self) -> tuple[torch.Tensor, torch.Tensor]:
        """x1 and x2 expanded to the operator's batch shape, before batch
        indexing."""
        batch = self._batch_shape()
        return self.x1.expand(*batch, *self.x1.shape[-2:]), self.x2.expand(*batch, *self.x2.shape[-2:])

    def _index_param(self, name: str, val: torch.Tensor, batch_indices) -> torch.Tensor:
        """val[*batch_indices, ...] with the hyperparameter broadcast to the
        operator's batch shape first; its non-batch dims stay whole."""
        k = self._nonbatch(name)
        if not batch_indices or val.ndim <= k:
            return val  # no batch index, or no batch dims: it broadcasts as it is
        nonbatch = tuple(val.shape[max(0, val.ndim - k) :]) if k else ()
        val = val.expand(*self._batch_shape(), *nonbatch)
        return val[(*batch_indices, *([slice(None)] * len(nonbatch)))]

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """k(x1[i], x2[j]) elementwise over broadcast index tensors: the
        pointwise evaluation pivoted Cholesky gathers its columns with.  Row
        i of a multi-output operator is output i % t1 of point i // t1."""
        t1, t2 = self.num_outputs_per_input
        x1, x2 = self._broadcast_data() if batch_indices else (self.x1, self.x2)
        x1 = x1[(*batch_indices, row_index // t1 if t1 != 1 else row_index, slice(None))]  # (*idx, d)
        x2 = x2[(*batch_indices, col_index // t2 if t2 != 1 else col_index, slice(None))]
        params = {name: self._index_param(name, val, batch_indices) for name, val in self.params.items()}
        vals = _covar_dense(
            self.covar_func(x1[..., None, :], x2[..., None, :], **params, **dict(self.static_params))
        )  # (*idx, t1, t2)
        if (t1, t2) == (1, 1):
            return vals[..., 0, 0]
        vals = torch.take_along_dim(vals, (row_index % t1)[..., None, None].expand(*vals.shape[:-2], 1, t2), dim=-2)
        return torch.take_along_dim(vals, (col_index % t2)[..., None, None].expand(*vals.shape[:-2], 1, 1), dim=-1)[
            ..., 0, 0
        ]

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        """K[*batch_indices, rows, cols] stays a lazy kernel operator on the
        sliced points.  It keeps the fused mat-vec, which takes every n, m,
        d and batch on the card: K1, and K3 where the slices are equal (a
        principal block stays symmetric).  The JAX package drops its fused
        engine here, whose Pallas path assumed the whole operator's shape;
        the values are the same.  A multi-output operator's rows are not
        its points: it indexes the covariance's own operator, as the JAX
        package does."""
        if self.num_outputs_per_input != (1, 1):
            return self._covar_mat_operator()._getitem(row_index, col_index, *batch_indices)
        x1, x2 = self._broadcast_data() if batch_indices else (self.x1, self.x2)
        params = {k: self._index_param(k, v, batch_indices) for k, v in self.params.items()}
        symmetric = self.symmetric and isinstance(row_index, slice) and row_index == col_index
        return self._replace(
            x1=x1[(*batch_indices, row_index, slice(None))],
            x2=x2[(*batch_indices, col_index, slice(None))],
            params=params,
            symmetric=symmetric,
            matvec_closure_impl=self.matvec_closure_impl if symmetric else None,
        )

    def _select_rows(self, idx) -> LinearOperator:
        """K[..., idx, :] stays a lazy kernel operator on the gathered points,
        with the fused rectangular mat-vec (K1 on the card)."""
        if self.num_outputs_per_input != (1, 1):
            return super()._select_rows(idx)
        return self._replace(x1=self.x1[..., idx, :], symmetric=False, matvec_closure_impl=None)

    def _select_cols(self, idx) -> LinearOperator:
        """K[..., :, idx] stays a lazy kernel operator on the gathered points,
        on the blocked path: the Nystrom preconditioner takes its landmark
        columns through here, in full f32 (the JAX package's choice)."""
        if self.num_outputs_per_input != (1, 1):
            return super()._select_cols(idx)
        return self._replace(
            x2=self.x2[..., idx, :], symmetric=False, matvec_impl=None, matvec_closure_impl=None
        )


# The JAX package's name for the lazy kernel operator, after the deprecated
# KeOps operator it stands in for
KeOpsLinearOperator = KernelLinearOperator


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
    """Rational quadratic: outputscale * (1 + d2 / (2 alpha))^-alpha, a scale
    mixture of RBF kernels; all four hyperparameters are differentiable."""
    d2 = _sq_dist(x1 / lengthscale, x2 / lengthscale)
    return outputscale * (1.0 + d2 / (2.0 * alpha)) ** (-alpha)


def periodic_covar(x1, x2, lengthscale, outputscale, period):
    """Periodic (MacKay) kernel:
    outputscale * exp(-2 sum_k sin^2(pi (x1_k - x2_k) / p_k) / l_k^2).

    ``lengthscale`` and ``period`` are scalars or per-dimension (d,)
    tensors.  Accumulated a dimension at a time, as ``sq_dist`` is, so that
    no (n, m, d) intermediate is formed."""
    ls, pd = torch.as_tensor(lengthscale), torch.as_tensor(period)
    s2 = None
    for k in range(x1.shape[-1]):
        p_k = pd[..., k] if pd.ndim else pd
        l_k = ls[..., k] if ls.ndim else ls
        s = torch.sin(math.pi * (x1[..., :, None, k] - x2[..., None, :, k]) / p_k)
        term = (s * s) / (l_k * l_k)
        s2 = term if s2 is None else s2 + term
    return outputscale * torch.exp(-2.0 * s2)


def spectral_mixture_covar(x1, x2, weights, means, scales):
    """Spectral mixture kernel (Wilson & Adams 2013, eq. 12):

        k(tau) = sum_q w_q prod_d exp(-2 pi^2 tau_d^2 s_qd^2) cos(2 pi mu_qd tau_d)

    with tau = x1 - x2, mixture ``weights`` (Q,), spectral ``means`` (Q, d)
    and ``scales`` (Q, d), all differentiable.  Accumulated a (q, d) pair
    at a time: the (n, m) difference of each dimension is formed once and
    serves the Q components; no (n, m, d) or (n, m, Q) intermediate."""
    means = torch.atleast_2d(torch.as_tensor(means))
    scales = torch.atleast_2d(torch.as_tensor(scales))
    acc = None  # each component's running product over the dimensions
    for dim in range(x1.shape[-1]):
        tau = x1[..., :, None, dim] - x2[..., None, :, dim]
        tau2 = tau * tau
        terms = [
            torch.exp(-2.0 * math.pi**2 * tau2 * scales[q, dim] ** 2) * torch.cos(2.0 * math.pi * means[q, dim] * tau)
            for q in range(means.shape[0])
        ]
        acc = [weights[q] * t for q, t in enumerate(terms)] if acc is None else [a * t for a, t in zip(acc, terms)]
    return sum(acc)


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


def matern52_fused_matvec(x1, x2, rhs, params, *, symmetric: bool = False):
    return fused_covar_matvec("matern52", x1, x2, rhs, params, symmetric=symmetric)


def matern32_fused_matvec(x1, x2, rhs, params, *, symmetric: bool = False):
    return fused_covar_matvec("matern32", x1, x2, rhs, params, symmetric=symmetric)


def matern12_fused_matvec(x1, x2, rhs, params, *, symmetric: bool = False):
    return fused_covar_matvec("matern12", x1, x2, rhs, params, symmetric=symmetric)


# One fused mat-vec per alpha, so that RQ operators of one alpha share it
_RQ_FUSED_IMPLS: dict = {}


def _rq_fused_matvec(alpha: float):
    """The fused mat-vec of the rational quadratic with ``alpha`` bound here,
    once: the kernels take it as a constant, so no alpha gradient flows
    through this path (the lengthscale's and outputscale's do)."""
    alpha = float(alpha)
    if alpha not in _RQ_FUSED_IMPLS:
        name = rq_tile_covar(alpha)

        def impl(x1, x2, rhs, params, *, symmetric=False, _name=name):
            return fused_covar_matvec(_name, x1, x2, rhs, params, symmetric=symmetric)

        _RQ_FUSED_IMPLS[alpha] = impl
    return _RQ_FUSED_IMPLS[alpha]


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


def _param(x, value) -> torch.Tensor:
    """A hyperparameter as a tensor of x's dtype on x's device (a tensor
    given so, a leaf of autograd included, is kept as it is)."""
    return torch.as_tensor(value, dtype=x.dtype, device=x.device)


def _stationary_operator(x1, x2, params, covar_func, fused, block_rows, materialize_threshold):
    return KernelLinearOperator(
        x1,
        x1 if x2 is None else x2,
        {name: _param(x1, value) for name, value in params.items()},
        covar_func=covar_func,
        block_rows=block_rows,
        symmetric=x2 is None,
        matvec_impl=fused,
        materialize_threshold=materialize_threshold,
    )


def rbf_kernel_operator(
    x1, x2=None, *, lengthscale, outputscale, block_rows: int = 4096,
    use_fused_kernels: bool = True, materialize_threshold: int | None = 2**30,
) -> KernelLinearOperator:
    """RBF kernel operator; ``use_fused_kernels`` routes its mat-vecs through
    the CUDA kernels (their plain versions for CPU tensors)."""
    return _stationary_operator(
        x1, x2, dict(lengthscale=lengthscale, outputscale=outputscale), rbf_covar,
        rbf_fused_matvec if use_fused_kernels else None, block_rows, materialize_threshold,
    )


_MATERN = {
    2.5: (matern52_covar, matern52_fused_matvec),
    1.5: (matern32_covar, matern32_fused_matvec),
    0.5: (matern12_covar, matern12_fused_matvec),
}


def matern_kernel_operator(
    x1, x2=None, *, lengthscale, outputscale, nu: float = 2.5, block_rows: int = 4096,
    use_fused_kernels: bool = True, materialize_threshold: int | None = 2**30,
) -> KernelLinearOperator:
    """Matern kernel operator, nu in {0.5, 1.5, 2.5}, on the engine of the
    RBF operator: ``use_fused_kernels`` routes its mat-vecs through K1 and
    K3 and its backward through K2 (their plain versions for CPU tensors).
    ``lengthscale`` is a scalar or one per dimension."""
    if nu not in _MATERN:
        raise ValueError(f"nu must be 0.5, 1.5 or 2.5, got {nu}")
    covar, fused = _MATERN[nu]
    return _stationary_operator(
        x1, x2, dict(lengthscale=lengthscale, outputscale=outputscale), covar,
        fused if use_fused_kernels else None, block_rows, materialize_threshold,
    )


def rq_kernel_operator(
    x1, x2=None, *, lengthscale, outputscale, alpha=2.0, block_rows: int = 4096,
    use_fused_kernels: bool = True, materialize_threshold: int | None = 2**30,
) -> KernelLinearOperator:
    """Rational-quadratic kernel operator.  ``alpha`` is a differentiable
    hyperparameter on the blocked path; with ``use_fused_kernels`` the
    kernels take its value at construction as a constant, so no alpha
    gradient flows through the fused mat-vec (the lengthscale's and
    outputscale's do), as in the JAX package."""
    return _stationary_operator(
        x1, x2, dict(lengthscale=lengthscale, outputscale=outputscale, alpha=alpha), rq_covar,
        _rq_fused_matvec(float(torch.as_tensor(alpha).detach())) if use_fused_kernels else None, block_rows, materialize_threshold,
    )


def periodic_kernel_operator(
    x1, x2=None, *, lengthscale, outputscale, period, block_rows: int = 4096,
    materialize_threshold: int | None = 2**30,
) -> KernelLinearOperator:
    """Periodic (MacKay) kernel operator.  Not a function of |x1 - x2|^2, so
    no kernel of ops/rbf.py evaluates it: the blocked engine (and the
    per-solve dense cache) only."""
    return _stationary_operator(
        x1, x2, dict(lengthscale=lengthscale, outputscale=outputscale, period=period), periodic_covar,
        None, block_rows, materialize_threshold,
    )


def spectral_mixture_kernel_operator(
    x1, x2=None, *, weights, means, scales, block_rows: int = 4096,
    materialize_threshold: int | None = 2**30,
) -> KernelLinearOperator:
    """Spectral mixture kernel operator (:func:`spectral_mixture_covar`).
    Not a function of |x1 - x2|^2, so no kernel of ops/rbf.py evaluates it:
    the blocked engine (and the per-solve dense cache) only."""
    return KernelLinearOperator(
        x1,
        x1 if x2 is None else x2,
        {
            "weights": _param(x1, weights),
            "means": torch.atleast_2d(_param(x1, means)),
            "scales": torch.atleast_2d(_param(x1, scales)),
        },
        covar_func=spectral_mixture_covar,
        block_rows=block_rows,
        symmetric=x2 is None,
        materialize_threshold=materialize_threshold,
    )
