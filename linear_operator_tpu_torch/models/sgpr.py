"""Sparse GP regression with inducing points (SGPR, Titsias 2009;
counterpart of linear_operator_tpu/models/sgpr.py).

The collapsed ELBO's Gaussian term is exactly a
``LowRankRootAddedDiagLinearOperator``: Q_nn + sigma^2 I with Q_nn = U U^T,
U = K_nm L_mm^{-T}.  Its inverse quadratic form and log-determinant are the
Woodbury and determinant-lemma closed forms, O(n m^2), with no CG, no SLQ
and no n x n factorization:

    ELBO = log N(y | 0, Q_nn + sigma^2 I) - (tr K_nn - tr Q_nn) / (2 sigma^2)

The model is an ``nn.Module``: the raw lengthscale, outputscale and noise
(each through a softplus) and the inducing locations ``z`` are parameters,
on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..functions import inv_quad_logdet
from ..operators.dense import DenseLinearOperator
from ..operators.kernel import rbf_covar
from ..operators.root import LowRankRootLinearOperator
from ..utils.cholesky import highest_matmul_precision, psd_safe_cholesky
from .gp import _softplus, model_device


class SGPRParams(NamedTuple):
    """The JAX package's parameter tuple; ``load_jax_params`` takes one (of
    numpy or JAX arrays) into a model's parameters."""

    raw_lengthscale: object
    raw_outputscale: object
    raw_noise: object
    z: object  # (m, d) inducing locations


def inducing_rows(n: int, m: int) -> torch.Tensor:
    """The rows of the training inputs that start as the m inducing points:
    round(linspace(0, n - 1, m)), rounding half to even, with linspace
    computed as the JAX package computes it with 64-bit floats ((n - 1) *
    (i / (m - 1)) in float64, the last point n - 1), whatever the inputs'
    dtype, so that both packages pick the same rows."""
    if m == 1:
        return torch.zeros(1, dtype=torch.int64)
    steps = (n - 1) * (np.arange(m - 1, dtype=np.float64) / (m - 1))
    return torch.from_numpy(np.rint(np.append(steps, n - 1)).astype(np.int64))


def kernel_diag(covar_func, x, lengthscale, outputscale) -> torch.Tensor:
    """k(x_i, x_i) for each point, as a batch of 1 x 1 kernel evaluations
    (no stationarity assumed of ``covar_func``)."""
    pts = x[..., :, None, :]
    return covar_func(pts, pts, lengthscale=lengthscale, outputscale=outputscale)[..., 0, 0]


class InducingPointModel(nn.Module):
    """What SGPR and SVGP share: the raw lengthscale, outputscale and noise
    (each through a softplus), the inducing locations ``z``, which start at
    evenly spaced rows of ``x`` (``inducing_rows``) and train, and the
    Cholesky factor of K_zz; the parameters take ``x``'s dtype, on
    ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, x: torch.Tensor, num_inducing: int, covar_func, jitter: float, device):
        super().__init__()
        device = model_device(device, type(self).__name__)
        self.covar_func = covar_func
        self.jitter = jitter
        kw = dict(dtype=x.dtype, device=device)
        self.raw_lengthscale = nn.Parameter(torch.zeros((), **kw))
        self.raw_outputscale = nn.Parameter(torch.zeros((), **kw))
        self.raw_noise = nn.Parameter(torch.full((), -2.0, **kw))
        rows = inducing_rows(x.shape[0], num_inducing).to(x.device)
        self.z = nn.Parameter(x[rows].detach().to(**kw))

    def _hyp(self):
        return _softplus(self.raw_lengthscale), _softplus(self.raw_outputscale), _softplus(self.raw_noise)

    def _chol_zz(self, ls, os_, jitter) -> torch.Tensor:
        """L with K_zz + jitter * I = L L^T (each model passes its own
        jitter convention)."""
        k_zz = self.covar_func(self.z, self.z, lengthscale=ls, outputscale=os_)
        eye = torch.eye(k_zz.shape[-1], dtype=k_zz.dtype, device=k_zz.device)
        return psd_safe_cholesky(k_zz + jitter * eye)


class SGPRRegression(InducingPointModel):
    """Collapsed-bound sparse GP regression (RBF kernel, ``covar_func``
    swappable) with ``num_inducing`` inducing points; K_mm takes a jitter
    scaled by the outputscale."""

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

    def _chol_mm(self, ls, os_) -> torch.Tensor:
        """L_mm with K_mm + jitter * outputscale * I = L_mm L_mm^T."""
        return self._chol_zz(ls, os_, self.jitter * os_)

    def _whitened_root(self, x: torch.Tensor) -> torch.Tensor:
        """U = K_nm L_mm^{-T}, so that U U^T = Q_nn: (n, m)."""
        ls, os_, _ = self._hyp()
        k_nm = self.covar_func(x, self.z, lengthscale=ls, outputscale=os_)
        return torch.linalg.solve_triangular(self._chol_mm(ls, os_), k_nm.mT, upper=False).mT

    def _kernel_diag(self, x: torch.Tensor) -> torch.Tensor:
        ls, os_, _ = self._hyp()
        return kernel_diag(self.covar_func, x, ls, os_)

    def _operator(self, u: torch.Tensor, n: int):
        noise = self._hyp()[2]
        return LowRankRootLinearOperator(DenseLinearOperator(u)).add_diagonal(noise.expand(n))

    def train_operator(self, x: torch.Tensor):
        """Q_nn + sigma^2 I as a LowRankRootAddedDiagLinearOperator (the
        exact Woodbury forms)."""
        return self._operator(self._whitened_root(x), x.shape[0])

    def elbo(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The collapsed lower bound on log p(y) (Titsias 2009, eq. 9)."""
        noise = self._hyp()[2]
        n = y.shape[-1]
        u = self._whitened_root(x)
        iq, ld = inv_quad_logdet(self._operator(u, n), y[..., None], logdet=True)
        gaussian = -0.5 * (torch.sum(iq) + ld + n * math.log(2.0 * math.pi))
        tr_k = torch.sum(self._kernel_diag(x))
        tr_q = torch.sum(u * u)
        return gaussian - 0.5 * (tr_k - tr_q) / noise

    def neg_elbo(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return -self.elbo(x, y) / y.shape[-1]

    def posterior(self, x: torch.Tensor, y: torch.Tensor, x_star: torch.Tensor):
        """Predictive mean and latent variance at ``x_star`` (Titsias 2009,
        eq. 6), in the whitened basis: with A = I + U^T U / sigma^2 = L_A L_A^T,
        mean = u_*^T A^{-1} U^T y / sigma^2 and var = k_** - |u_*|^2 +
        |L_A^{-1} u_*|^2, u_* = L_mm^{-1} k_m*."""
        ls, os_, noise = self._hyp()
        m = self.z.shape[0]
        u = self._whitened_root(x)
        eye = torch.eye(m, dtype=u.dtype, device=u.device)
        with highest_matmul_precision():
            a = eye + (u.mT @ u) / noise
            uy = u.mT @ y[..., None]  # (m, 1)
        l_a = psd_safe_cholesky(a)
        w = torch.linalg.solve_triangular(l_a, uy, upper=False)
        w = torch.linalg.solve_triangular(l_a.mT, w, upper=True)  # A^{-1} U^T y
        k_sm = self.covar_func(x_star, self.z, lengthscale=ls, outputscale=os_)
        u_star_t = torch.linalg.solve_triangular(self._chol_mm(ls, os_), k_sm.mT, upper=False)  # (m, n_*)
        mean = (u_star_t.mT @ w)[..., 0] / noise
        v = torch.linalg.solve_triangular(l_a, u_star_t, upper=False)
        var = self._kernel_diag(x_star) - torch.sum(u_star_t * u_star_t, dim=-2) + torch.sum(v * v, dim=-2)
        return mean, torch.clamp_min(var, 0.0)


__all__ = ["InducingPointModel", "SGPRParams", "SGPRRegression", "inducing_rows"]
