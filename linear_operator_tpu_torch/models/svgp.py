"""Stochastic variational GP regression (SVGP, Hensman et al. 2013;
counterpart of linear_operator_tpu/models/svgp.py).

The variational distribution q(u) = N(m, S) is explicit, so the ELBO is a
sum over data points and takes minibatches.  Whitened parameterization
(q over eps with u = L_zz eps): with A = L_zz^{-1} K_zx,

    q(f_i) = N(a_i^T m_w,  k_ii - a_i^T a_i + a_i^T S_w a_i)
    ELBO   = sum_i E_{q(f_i)}[log N(y_i | f_i, sigma^2)] - KL(q || N(0, I))

The KL is the closed-form whitened Gaussian KL, and the Gaussian
likelihood's expectation is analytic.  A step costs one (m, m) Cholesky,
(m, batch) triangular solves and (batch, m) products.  S_w = R R^T with R
lower triangular with a softplus diagonal, so S_w stays positive definite
under any step and the KL's logdet is a sum over R's diagonal.

The model is an ``nn.Module``: the raw hyperparameters, the inducing
locations ``z`` and the variational parameters ``var_mean`` and
``var_root_raw`` are parameters, on ``device`` ("cuda" unless the caller
asks for the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..operators.kernel import rbf_covar
from .gp import _softplus
from .sgpr import InducingPointModel, kernel_diag


class SVGPParams(NamedTuple):
    """The JAX package's parameter tuple; ``load_jax_params`` takes one (of
    numpy or JAX arrays) into a model's parameters."""

    raw_lengthscale: object
    raw_outputscale: object
    raw_noise: object
    z: object  # (m, d) inducing locations
    var_mean: object  # (m,) whitened variational mean
    var_root_raw: object  # (m, m) unconstrained; its lower triangle -> the root of S_w


def _var_root(raw: torch.Tensor) -> torch.Tensor:
    """Lower-triangular root with a positive (softplus) diagonal from an
    unconstrained square matrix."""
    return torch.tril(raw, -1) + torch.diag(_softplus(torch.diagonal(raw)))


class SVGPRegression(InducingPointModel):
    """Minibatch variational GP regression (RBF kernel, ``covar_func``
    swappable) with ``num_inducing`` inducing points (``InducingPointModel``)
    and q(u) at the prior (zero mean, S_w = I); K_zz takes the jitter
    unscaled."""

    def __init__(
        self,
        x: torch.Tensor,
        num_inducing: int,
        covar_func=rbf_covar,
        jitter: float = 1e-6,
        *,
        device: str | torch.device = "cuda",
    ):
        super().__init__(x, num_inducing, covar_func, jitter, device)
        m = num_inducing
        kw = dict(dtype=self.z.dtype, device=self.z.device)
        self.var_mean = nn.Parameter(torch.zeros((m,), **kw))
        # S_w = I at the start: softplus^{-1}(1) on the diagonal
        self.var_root_raw = nn.Parameter(math.log(math.expm1(1.0)) * torch.eye(m, **kw))

    def _whitened(self, x: torch.Tensor):
        """A = L_zz^{-1} K_zx (m, n) and the diagonal k_ii of K_xx."""
        ls, os_, _ = self._hyp()
        k_zx = self.covar_func(self.z, x, lengthscale=ls, outputscale=os_)
        a = torch.linalg.solve_triangular(self._chol_zz(ls, os_, self.jitter), k_zx, upper=False)
        return a, kernel_diag(self.covar_func, x, ls, os_)

    def predictive(self, x: torch.Tensor):
        """The marginal mean and variance of q(f) at x, O(m^2 (m + n))."""
        a, k_diag = self._whitened(x)
        r = _var_root(self.var_root_raw)
        mean = a.mT @ self.var_mean
        ra = r.mT @ a  # (m, n)
        var = k_diag - torch.sum(a * a, dim=0) + torch.sum(ra * ra, dim=0)
        return mean, torch.clamp_min(var, 1e-12)

    def kl(self) -> torch.Tensor:
        """KL(N(m_w, R R^T) || N(0, I)) = (|R|_F^2 + |m_w|^2 - m - 2 sum log
        diag R) / 2."""
        r = _var_root(self.var_root_raw)
        m = r.shape[-1]
        return 0.5 * (
            torch.sum(r * r) + torch.sum(self.var_mean**2) - m - 2.0 * torch.sum(torch.log(torch.diagonal(r)))
        )

    def expected_log_lik(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """E_{q(f_i)}[log p(y_i | f_i)] for each point; for the Gaussian
        likelihood -(log 2 pi sigma^2 + ((y - mu)^2 + var) / sigma^2) / 2.
        The non-conjugate models (``models/classification.py``) override it."""
        noise = self._hyp()[2]
        mean, var = self.predictive(x)
        return -0.5 * (torch.log(2.0 * math.pi * noise) + ((y - mean) ** 2 + var) / noise)

    def elbo(self, x: torch.Tensor, y: torch.Tensor, *, num_data: int | None = None) -> torch.Tensor:
        """The evidence lower bound; ``num_data`` scales a minibatch's data
        term to the whole data set (Hensman et al. 2013, eq. 4)."""
        batch = y.shape[-1]
        n = batch if num_data is None else num_data
        return (n / batch) * torch.sum(self.expected_log_lik(x, y)) - self.kl()

    def neg_elbo(self, x: torch.Tensor, y: torch.Tensor, *, num_data: int | None = None) -> torch.Tensor:
        return -self.elbo(x, y, num_data=num_data)

    def posterior(self, x_star: torch.Tensor):
        """The predictive mean and variance of f at ``x_star`` (add the
        noise for y)."""
        return self.predictive(x_star)

    def posterior_distribution(self, x_star: torch.Tensor):
        """The joint q(f_*) as a MultivariateNormal over a lazy covariance,
        K_ss - A^T A + (R^T A)^T (R^T A), kept as a sum of the prior and two
        low-rank roots, plus the model's jitter."""
        from ..distributions import MultivariateNormal
        from ..operators import ConstantMulLinearOperator, RootLinearOperator, to_linear_operator

        ls, os_, _ = self._hyp()
        a, _ = self._whitened(x_star)
        r = _var_root(self.var_root_raw)
        mean = a.mT @ self.var_mean
        k_ss = self.covar_func(x_star, x_star, lengthscale=ls, outputscale=os_)
        cov = (
            to_linear_operator(k_ss)
            + ConstantMulLinearOperator(RootLinearOperator(a.mT), -1.0)
            + RootLinearOperator((r.mT @ a).mT)
        )
        return MultivariateNormal(mean, cov.add_jitter(self.jitter))


__all__ = ["SVGPParams", "SVGPRegression"]
