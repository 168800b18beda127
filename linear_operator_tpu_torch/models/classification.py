"""Variational GP classification and Poisson regression (SVGP with a
non-conjugate likelihood; counterpart of
linear_operator_tpu/models/classification.py).

The whitened variational machinery of ``SVGPRegression`` (inducing points,
q(u), the KL) is shared; only the data term changes.

- ``SVGPClassification``: E_{q(f_i)}[log p(y_i | f_i)] has no closed form
  and is taken by Gauss-Hermite quadrature.  Probit (the default) is
  log Phi(y f), whose predictive class probability is analytic,
  Phi(mu / sqrt(1 + var)); logit is log sigmoid(y f), its predictive
  probability also by quadrature.
- ``SVGPPoissonRegression``: rate exp(f); the expectation is closed form,
  y mu - exp(mu + var / 2) - lgamma(y + 1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .svgp import SVGPRegression


def gauss_hermite_expectation(fn, mean: torch.Tensor, var: torch.Tensor, num_points: int = 20) -> torch.Tensor:
    """E_{f ~ N(mean, var)}[fn(f)] by Gauss-Hermite quadrature, batched over
    the dims of ``mean`` and ``var``: with f = mean + sqrt(2 var) t the rule
    gives sum_q w_q fn(f_q) / sqrt(pi).  The nodes and weights are numpy's
    ``hermgauss``."""
    nodes, weights = np.polynomial.hermite.hermgauss(num_points)
    nodes = torch.as_tensor(nodes, dtype=mean.dtype, device=mean.device)
    weights = torch.as_tensor(weights / np.sqrt(np.pi), dtype=mean.dtype, device=mean.device)
    f = mean[..., None] + torch.sqrt(2.0 * var)[..., None] * nodes
    return torch.sum(fn(f) * weights, dim=-1)


class SVGPClassification(SVGPRegression):
    """Binary GP classification with inducing points (minibatch ELBO).

    Labels ``y`` are {0, 1}, taken as -1 and +1: both links are symmetric,
    log p(y | f) = log g(sign(y) f).  ``raw_noise`` is unused."""

    def __init__(
        self,
        x: torch.Tensor,
        num_inducing: int,
        *args,
        likelihood: str = "probit",
        num_quadrature_points: int = 20,
        **kwargs,
    ):
        if likelihood not in ("probit", "logit"):
            raise ValueError("likelihood must be 'probit' or 'logit'")
        super().__init__(x, num_inducing, *args, **kwargs)
        self.likelihood = likelihood
        self.num_quadrature_points = num_quadrature_points

    def _log_lik(self, z: torch.Tensor) -> torch.Tensor:
        return torch.special.log_ndtr(z) if self.likelihood == "probit" else F.logsigmoid(z)

    def expected_log_lik(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """E_{q(f_i)}[log p(y_i | f_i)] for each point, (batch,)."""
        mean, var = self.predictive(x)
        sign = 2.0 * y.to(mean.dtype) - 1.0
        return gauss_hermite_expectation(
            lambda f: self._log_lik(sign[..., None] * f), mean, var, self.num_quadrature_points
        )

    def predict_proba(self, x_star: torch.Tensor) -> torch.Tensor:
        """p(y = 1 | x_star) for each point: probit exactly, Phi(mu /
        sqrt(1 + var)); logit by quadrature of the sigmoid."""
        mean, var = self.predictive(x_star)
        if self.likelihood == "probit":
            return torch.special.ndtr(mean / torch.sqrt(1.0 + var))
        return gauss_hermite_expectation(torch.sigmoid, mean, var, self.num_quadrature_points)

    def predict(self, x_star: torch.Tensor) -> torch.Tensor:
        """Hard labels in {0, 1} (int32)."""
        return (self.predict_proba(x_star) >= 0.5).to(torch.int32)


class SVGPPoissonRegression(SVGPRegression):
    """Poisson count regression with a log link (non-conjugate SVGP)."""

    def expected_log_lik(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mean, var = self.predictive(x)
        y = y.to(mean.dtype)
        return y * mean - torch.exp(mean + 0.5 * var) - torch.lgamma(y + 1.0)

    def predict_rate(self, x_star: torch.Tensor) -> torch.Tensor:
        """The posterior-expected rate E[exp(f)] = exp(mu + var / 2) for each
        point."""
        mean, var = self.predictive(x_star)
        return torch.exp(mean + 0.5 * var)


__all__ = ["SVGPClassification", "SVGPPoissonRegression", "gauss_hermite_expectation"]
