"""Exact GP regression on the operator engine (counterpart of
linear_operator_tpu/models/gp.py).

K = k(X, X) + noise I as a lazy KernelLinearOperator plus a constant
diagonal, and

    -2 log p(y) = y^T K^{-1} y + log|K| + n log 2 pi

from ``inv_quad_logdet``: Cholesky below the size cutoff, preconditioned CG
+ SLQ above it.  A training step is ``loss = model.neg_mll(x, y,
generator=g); loss.backward()``: the backward reuses the forward's solves, and
on the fused path runs through the kernels' backward (K2).

Serving (LOVE, Pleiss et al. 2018): ``posterior_cache`` runs one CG solve
for alpha = K^{-1} y and one Lanczos inverse root R with R R^T ~= K^{-1}
(``max_root_decomposition_size`` steps, each one kernel mat-vec); each batch
of queries then costs two cross-covariance products and no solve
(``posterior_from_cache``).  ``posterior_distribution`` returns the joint
predictive over the same cache as a lazy-covariance MultivariateNormal.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..functions import inv_quad_logdet, solve
from ..operators.kernel import KernelLinearOperator, rbf_covar, rbf_fused_matvec
from ..utils.cholesky import highest_matmul_precision


class GPParams(NamedTuple):
    """The JAX package's parameter tuple; ``load_jax_params`` takes one (of
    numpy or JAX arrays) into a model's parameters."""

    raw_lengthscale: object
    raw_outputscale: object
    raw_noise: object


class PosteriorCache(NamedTuple):
    """The training-time prediction caches of ``posterior_cache``."""

    alpha: torch.Tensor  # (*b, n, 1)  K^{-1} y
    root_inv: torch.Tensor  # (*b, n, k)  R with R R^T ~= K^{-1}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus(x) + 1e-6; torch's softplus turns linear above 20
    return torch.logaddexp(x, torch.zeros_like(x)) + 1e-6


def model_device(device: str | torch.device, model: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device where none is available
    raises, naming ``model``: the models run on the card unless the caller
    asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{model} runs on a CUDA device by default and none is available; pass device='cpu' to run on the CPU"
        )
    return device


def love_posterior(K, k_star, y, k_ss_diag, *, generator: torch.Generator | None = None):
    """Predictive mean and variance from a train operator ``K``, a lazy
    cross-covariance ``k_star`` (*b, m, n), targets ``y`` and the prior
    diagonal at the query points, the LOVE way: var = k_ss_diag -
    row_norms(k_star R)^2 with R an inverse root of K.  Where ``K`` is
    row-sharded (``parallel.row_sharded``), ``y`` and R are the rank's rows
    and ``k_star`` the rank's columns: the two products are the rank's
    shares, summed over the model group in one all-reduce of (m, k + 1), so
    that mean and variance are whole on every rank."""
    alpha = solve(K, y[..., None])
    mean = (k_star @ alpha)[..., 0]
    v = k_star @ K.root_inv_decomposition(generator=generator).root.to_dense()  # (*b, m, k)
    group = getattr(K, "row_group", None)
    if group is not None:
        from ..parallel._comm import sum_shares

        both = sum_shares(torch.cat([mean[..., None], v], dim=-1), group, name="posterior")
        mean, v = both[..., 0], both[..., 1:]
    var = k_ss_diag - torch.sum(v * v, dim=-1)
    return mean, torch.clamp_min(var, 0.0)


class ExactGPRegression(nn.Module):
    """Exact GP with an RBF kernel (``covar_func`` swappable) and scalar,
    softplus-parameterized lengthscale, outputscale and noise.

    ``use_fused_kernels`` routes the kernel mat-vecs of an RBF model through
    the CUDA kernels of ``ops/rbf.py`` (their plain versions for CPU
    tensors).  The parameters, and so the computation, live on ``device``:
    "cuda" unless the caller asks for the CPU."""

    def __init__(
        self,
        covar_func=rbf_covar,
        block_rows: int = 4096,
        use_fused_kernels: bool = True,
        materialize_threshold: int | None = 2**30,
        *,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        device = model_device(device, "ExactGPRegression")
        self.covar_func = covar_func
        self.block_rows = block_rows
        self.use_fused_kernels = use_fused_kernels and covar_func is rbf_covar
        self.materialize_threshold = materialize_threshold
        kw = dict(dtype=dtype, device=device)
        self.raw_lengthscale = nn.Parameter(torch.zeros((), **kw))
        self.raw_outputscale = nn.Parameter(torch.zeros((), **kw))
        self.raw_noise = nn.Parameter(torch.full((), -2.0, **kw))

    def _kernel_args(self):
        params = {
            "lengthscale": _softplus(self.raw_lengthscale),
            "outputscale": _softplus(self.raw_outputscale),
        }
        kw = dict(
            covar_func=self.covar_func,
            block_rows=self.block_rows,
            matvec_impl=rbf_fused_matvec if self.use_fused_kernels else None,
            materialize_threshold=self.materialize_threshold,
        )
        return params, kw

    def covariance(self, x1, x2=None, symmetric: bool | None = None) -> KernelLinearOperator:
        """k(x1, x2), lazily.  Under an ambient mesh with a ``model`` axis
        above 1 the training points are the rank's rows: k(x1, x1) of this
        rank's rows x1 is row-sharded (``parallel.row_sharded``), and a
        cross-covariance k(x1, x2) with x2 the rank's rows is the rank's
        columns, whose parameters' gradients are summed over the model group
        (each rank computes its share of a product with it:
        ``parallel._comm.sum_grads``)."""
        if symmetric is None:
            symmetric = x2 is None
        params, kw = self._kernel_args()
        mesh = _current_mesh()
        if mesh is not None and mesh.size("model") > 1:
            from ..parallel import _comm
            from ..parallel.row_sharded import row_sharded_kernel_operator

            if x2 is None:
                return row_sharded_kernel_operator(x1, params, mesh, **kw)
            params = dict(zip(params, _comm.sum_grads(tuple(params.values()), mesh.group("model"))))
        return KernelLinearOperator(x1, x1 if x2 is None else x2, params, symmetric=symmetric, **kw)

    def _prior_diagonal(self, x_star) -> torch.Tensor:
        """k(x_star, x_star)'s diagonal, whole on every rank of a mesh."""
        return self._prior(x_star).diagonal()

    def _prior(self, x_star) -> KernelLinearOperator:
        """k(x_star, x_star), the same on every rank of a mesh."""
        params, kw = self._kernel_args()
        return KernelLinearOperator(x_star, x_star, params, symmetric=True, **kw)

    def train_operator(self, x):
        return self.covariance(x).add_diagonal(_softplus(self.raw_noise))

    def neg_mll(self, x, y, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """Negative marginal log-likelihood, averaged over data points.

        x: (*b, n, d); y: (*b, n); batch dims are independent GPs.  Under an
        ambient mesh (``parallel/``) x and y are this rank's block
        (``shard_gp_batch``) and the loss is the whole batch's mean, the same
        on every rank; its gradient on a rank is the rank's share, which
        ``sharded_train_step`` sums over the ``data`` axis."""
        return mll_loss(self.train_operator(x), y, generator)

    def posterior(self, x, y, x_star):
        """Predictive mean and variance at x_star, from ONE batched CG over
        [y | k_*^T]: the mean and variance solves share every kernel
        mat-vec, and the (m, n) cross block is formed once.

        Under an ambient mesh with a ``model`` axis above 1, x and y are the
        rank's rows (``shard_gp_batch``) and x_star is whole on every rank:
        the cross block is the rank's rows, the solve runs on them, and the
        mean and the variance's downdate are summed over the model group in
        one all-reduce, so that both are the same on every rank."""
        K = self.train_operator(x).with_preconditioner()
        ks_t = self.covariance(x_star, x).mT.to_dense()  # (*b, n, m)
        y_col = y[..., None]  # (*by, n, 1)
        batch = torch.broadcast_shapes(y_col.shape[:-2], ks_t.shape[:-2])
        ks_t = ks_t.expand(*batch, *ks_t.shape[-2:])
        stacked = torch.cat([y_col.expand(*batch, *y_col.shape[-2:]), ks_t], dim=-1)
        sol = solve(K, stacked)
        alpha, v = sol[..., :1], sol[..., 1:]
        with highest_matmul_precision():
            mean = torch.einsum("...nm,...no->...m", ks_t, alpha)
            downdate = torch.einsum("...nm,...nm->...m", ks_t, v)
            mean, downdate = _sum_rows(torch.stack([mean, downdate], dim=-1), "posterior").unbind(-1)
            var = self._prior_diagonal(x_star) - downdate
        return mean, torch.clamp_min(var, 0.0)

    def posterior_cache(self, x, y, *, generator: torch.Generator | None = None) -> PosteriorCache:
        """The training-dependent part of prediction, computed once: alpha =
        K^{-1} y by CG and an inverse root R (R R^T ~= K^{-1}) by Lanczos,
        sharing one preconditioner factor.  ``generator`` draws the Lanczos
        start vector (a fixed one when None).  Under an ambient mesh with a
        ``model`` axis above 1, alpha and R are the rank's rows."""
        K = self.train_operator(x).with_preconditioner()
        alpha = solve(K, y[..., None])
        root_inv = K.root_inv_decomposition(generator=generator).root.to_dense()
        return PosteriorCache(alpha=alpha, root_inv=root_inv)

    def posterior_from_cache(self, x, cache: PosteriorCache, x_star):
        """Predictive mean and variance at ``x_star`` from the cache: two
        products with the lazy cross-covariance k(x_star, x), no solve.
        Under an ambient mesh with a ``model`` axis above 1 (x and the cache
        the rank's rows, x_star whole), the two products are the rank's
        shares, summed over the model group in one all-reduce of (m, k + 1)."""
        mean, v = self._cached_products(x, cache, x_star, "posterior_from_cache")
        var = self._prior_diagonal(x_star) - torch.sum(v * v, dim=-1)
        return mean, torch.clamp_min(var, 0.0)

    def _cached_products(self, x, cache: PosteriorCache, x_star, name: str):
        """(K_s* alpha (*b, m), K_s* R (*b, m, k)): two products with the
        lazy cross-covariance; under an ambient mesh with a ``model`` axis
        above 1 the rank's shares, summed over the model group in one
        all-reduce of (m, 1 + k) named ``name``."""
        k_star = self.covariance(x_star, x)  # (*b, m, n)
        mean = (k_star @ cache.alpha)[..., 0]
        v = k_star @ cache.root_inv  # (*b, m, k)
        both = _sum_rows(torch.cat([mean[..., None], v], dim=-1), name)
        return both[..., 0], both[..., 1:]

    def posterior_distribution(self, x, y, x_star, *, generator: torch.Generator | None = None):
        """The joint predictive at ``x_star`` as a MultivariateNormal over a
        lazy covariance, K_ss - K_s* K^{-1} K_*s, kept as the sum of the prior
        operator and a downdate root (K_s* R with R the LOVE cache's inverse
        root), plus a jitter of 1e-6; nothing of size m x m is formed until a
        density or a draw asks for it.  ``generator`` draws the cache's
        Lanczos start.

        Under an ambient mesh with a ``model`` axis above 1 (x, y and the
        cache the rank's rows, x_star whole), the mean and the downdate root
        are the rank's shares summed in one all-reduce of (m, 1 + k), and
        the prior is k(x_star, x_star) on every rank: the distribution is
        the same on every rank of a model group, and its densities and
        draws run on the replicated m x m."""
        from ..distributions import MultivariateNormal
        from ..operators import ConstantMulLinearOperator, RootLinearOperator

        cache = self.posterior_cache(x, y, generator=generator)
        mean, v = self._cached_products(x, cache, x_star, "posterior_distribution")
        downdate = ConstantMulLinearOperator(RootLinearOperator(v), -1.0)
        return MultivariateNormal(mean, (self._prior(x_star) + downdate).add_jitter(1e-6))


def mll_loss(K, y, generator: torch.Generator | None = None) -> torch.Tensor:
    """The negative MLL a point of the train operator ``K`` at targets ``y``,
    averaged over the batch.  Under an ambient mesh (``parallel/``) ``K`` may
    be row-sharded and ``y`` the rank's block: n is K's whole n, and the
    loss is the whole batch's mean, the same on every rank (the data ranks'
    shares summed by ``_comm.sum_shares``)."""
    n = K.shape[-1]
    iq, ld = inv_quad_logdet(K, y[..., None], logdet=True, generator=generator)
    terms = iq + ld + n * math.log(2.0 * math.pi)
    mesh = _current_mesh()
    if mesh is None or mesh.size("data") == 1:
        return 0.5 * torch.mean(terms) / n
    from ..parallel._comm import sum_shares

    return 0.5 * sum_shares(torch.sum(terms) / (terms.numel() * mesh.size("data")), mesh.group("data")) / n


def _current_mesh():
    from ..parallel.sharding import _current_mesh as current

    return current()


def _sum_rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """Under an ambient mesh with a ``model`` axis above 1, the sum of the
    ranks' shares ``t`` over the model group (``_comm.sum_shares``);
    otherwise ``t``."""
    mesh = _current_mesh()
    if mesh is None or mesh.size("model") == 1:
        return t
    from ..parallel._comm import sum_shares

    return sum_shares(t, mesh.group("model"), name=name)


def load_jax_params(model, params):
    """Fill ``model``'s parameters from the JAX package's parameter tuple of
    the same model (of numpy or JAX arrays), or a mapping with the same field
    names: ``GPParams``, ``SKIParams``, ``SGPRParams``, ``SVGPParams``,
    ``MultitaskGPParams`` or ``DKLParams``.  Each field replaces the
    parameter of its name, whose dtype and device it takes (its shape it takes
    from the JAX array: a different number of inducing points is carried
    across).  A ``DKLParams``'s MLP weights are (in, out), ``h @ w + b``;
    ``nn.Linear`` stores (out, in), so they are transposed."""
    fields = params if isinstance(params, Mapping) else params._asdict()
    if "mlp" in fields:
        mlp = fields["mlp"] if isinstance(fields["mlp"], Mapping) else fields["mlp"]._asdict()
        layers = [m for m in model.mlp if isinstance(m, nn.Linear)]
        if len(layers) != len(mlp["weights"]):
            raise ValueError(f"the MLP has {len(layers)} layers, the parameters {len(mlp['weights'])}")
        for layer, w, b in zip(layers, mlp["weights"], mlp["biases"]):
            _load(layer, "weight", np.array(w).T)
            _load(layer, "bias", b)
        load_jax_params(model.gp, fields["gp"])
        return model
    for name, value in fields.items():
        _load(model, name, value)
    return model


def _load(module: nn.Module, name: str, value) -> None:
    old = getattr(module, name)
    setattr(module, name, nn.Parameter(torch.tensor(np.array(value), dtype=old.dtype, device=old.device)))


def load_jax_cache(model: ExactGPRegression, cache) -> PosteriorCache:
    """The JAX package's ``PosteriorCache`` (of numpy or JAX arrays) as a
    PosteriorCache of tensors in ``model``'s dtype, on its device."""
    kw = dict(dtype=model.raw_noise.dtype, device=model.raw_noise.device)
    return PosteriorCache(
        alpha=torch.tensor(np.array(cache.alpha), **kw), root_inv=torch.tensor(np.array(cache.root_inv), **kw)
    )
