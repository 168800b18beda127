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
    row_norms(k_star R)^2 with R an inverse root of K."""
    alpha = solve(K, y[..., None])
    mean = (k_star @ alpha)[..., 0]
    v = k_star @ K.root_inv_decomposition(generator=generator).root.to_dense()  # (*b, m, k)
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

    def covariance(self, x1, x2=None, symmetric: bool | None = None) -> KernelLinearOperator:
        if symmetric is None:
            symmetric = x2 is None
        return KernelLinearOperator(
            x1,
            x1 if x2 is None else x2,
            {
                "lengthscale": _softplus(self.raw_lengthscale),
                "outputscale": _softplus(self.raw_outputscale),
            },
            covar_func=self.covar_func,
            block_rows=self.block_rows,
            symmetric=symmetric,
            matvec_impl=rbf_fused_matvec if self.use_fused_kernels else None,
            materialize_threshold=self.materialize_threshold,
        )

    def train_operator(self, x):
        return self.covariance(x).add_diagonal(_softplus(self.raw_noise))

    def neg_mll(self, x, y, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """Negative marginal log-likelihood, averaged over data points.

        x: (*b, n, d); y: (*b, n); batch dims are independent GPs."""
        n = y.shape[-1]
        K = self.train_operator(x)
        iq, ld = inv_quad_logdet(K, y[..., None], logdet=True, generator=generator)
        return 0.5 * torch.mean(iq + ld + n * math.log(2.0 * math.pi)) / n

    def posterior(self, x, y, x_star):
        """Predictive mean and variance at x_star, from ONE batched CG over
        [y | k_*^T]: the mean and variance solves share every kernel
        mat-vec, and the (m, n) cross block is formed once."""
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
            k_ss_diag = self.covariance(x_star).diagonal()
            var = k_ss_diag - torch.einsum("...nm,...nm->...m", ks_t, v)
        return mean, torch.clamp_min(var, 0.0)

    def posterior_cache(self, x, y, *, generator: torch.Generator | None = None) -> PosteriorCache:
        """The training-dependent part of prediction, computed once: alpha =
        K^{-1} y by CG and an inverse root R (R R^T ~= K^{-1}) by Lanczos,
        sharing one preconditioner factor.  ``generator`` draws the Lanczos
        start vector (a fixed one when None)."""
        K = self.train_operator(x).with_preconditioner()
        alpha = solve(K, y[..., None])
        root_inv = K.root_inv_decomposition(generator=generator).root.to_dense()
        return PosteriorCache(alpha=alpha, root_inv=root_inv)

    def posterior_from_cache(self, x, cache: PosteriorCache, x_star):
        """Predictive mean and variance at ``x_star`` from the cache: two
        products with the lazy cross-covariance k(x_star, x), no solve."""
        k_star = self.covariance(x_star, x)  # (*b, m, n)
        mean = (k_star @ cache.alpha)[..., 0]
        v = k_star @ cache.root_inv  # (*b, m, k)
        var = self.covariance(x_star).diagonal() - torch.sum(v * v, dim=-1)
        return mean, torch.clamp_min(var, 0.0)

    def posterior_distribution(self, x, y, x_star, *, generator: torch.Generator | None = None):
        """The joint predictive at ``x_star`` as a MultivariateNormal over a
        lazy covariance, K_ss - K_s* K^{-1} K_*s, kept as the sum of the prior
        operator and a downdate root (K_s* R with R the LOVE cache's inverse
        root), plus a jitter of 1e-6; nothing of size m x m is formed until a
        density or a draw asks for it.  ``generator`` draws the cache's
        Lanczos start."""
        from ..distributions import MultivariateNormal
        from ..operators import ConstantMulLinearOperator, RootLinearOperator

        cache = self.posterior_cache(x, y, generator=generator)
        k_star = self.covariance(x_star, x)  # (*b, m, n)
        mean = (k_star @ cache.alpha)[..., 0]
        v = k_star @ cache.root_inv  # (*b, m, k)
        downdate = ConstantMulLinearOperator(RootLinearOperator(v), -1.0)
        return MultivariateNormal(mean, (self.covariance(x_star) + downdate).add_jitter(1e-6))


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
