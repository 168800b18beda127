"""Multitask GP regression (Bonilla et al. 2008; counterpart of
linear_operator_tpu/models/multitask.py): K = K_xx (x) K_tt + sigma^2 I.

The data kernel K_xx (RBF) and a free-form low-rank task covariance
K_tt = B B^T + diag(v) make an (nT x nT) operator whose solve and
log-determinant are ``KroneckerProductAddedDiagLinearOperator``'s closed
forms for a constant noise: the factors' eigendecompositions and Kronecker
sweeps, never an (nT)^2 matrix.

The model is an ``nn.Module``: the raw lengthscale, outputscale, task
diagonal and noise (each through a softplus) and the task root B are
parameters, on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..functions import inv_quad_logdet, solve
from ..operators import DenseLinearOperator, KroneckerProductLinearOperator
from ..operators.kernel import rbf_covar
from .gp import _softplus, love_posterior, model_device


class MultitaskGPParams(NamedTuple):
    """The JAX package's parameter tuple; ``load_jax_params`` takes one (of
    numpy or JAX arrays) into a model's parameters."""

    raw_lengthscale: object
    raw_outputscale: object
    task_root: object  # (T, r) free-form low-rank task factor
    raw_task_diag: object  # (T,)
    raw_noise: object


class MultitaskGPRegression(nn.Module):
    """Exact multitask GP with an RBF data kernel and a free-form task
    kernel of rank ``task_rank``.  y is (n, T); the joint covariance of
    vec(y), the task index fastest, is K_xx (x) K_tt + sigma^2 I."""

    def __init__(
        self,
        num_tasks: int,
        task_rank: int = 2,
        *,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        device = model_device(device, "MultitaskGPRegression")
        self.num_tasks = num_tasks
        self.task_rank = task_rank
        kw = dict(dtype=dtype, device=device)
        self.raw_lengthscale = nn.Parameter(torch.zeros((), **kw))
        self.raw_outputscale = nn.Parameter(torch.zeros((), **kw))
        self.task_root = nn.Parameter(torch.eye(num_tasks, task_rank, **kw))
        self.raw_task_diag = nn.Parameter(torch.zeros((num_tasks,), **kw))
        self.raw_noise = nn.Parameter(torch.full((), -2.0, **kw))

    def task_covar(self) -> torch.Tensor:
        B = self.task_root
        return B @ B.mT + torch.diag(_softplus(self.raw_task_diag))

    def data_covar(self, x1: torch.Tensor, x2: torch.Tensor | None = None) -> torch.Tensor:
        return rbf_covar(
            x1,
            x1 if x2 is None else x2,
            lengthscale=_softplus(self.raw_lengthscale),
            outputscale=_softplus(self.raw_outputscale),
        )

    def train_operator(self, x: torch.Tensor):
        kron = KroneckerProductLinearOperator(
            (DenseLinearOperator(self.data_covar(x)), DenseLinearOperator(self.task_covar()))
        )
        return kron.add_diagonal(_softplus(self.raw_noise))

    def neg_mll(self, x: torch.Tensor, y: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """The negative marginal log-likelihood over the n T entries,
        averaged; x (n, d), y (n, T)."""
        n, T = y.shape
        K = self.train_operator(x)
        iq, ld = inv_quad_logdet(K, y.reshape(n * T)[:, None], logdet=True, generator=generator)
        return 0.5 * (iq + ld + n * T * math.log(2.0 * math.pi)) / (n * T)

    def _cross_covar(self, x_star: torch.Tensor, x: torch.Tensor):
        """K(x_star, x) (x) K_tt as a lazy rectangular Kronecker operator."""
        return KroneckerProductLinearOperator(
            (DenseLinearOperator(self.data_covar(x_star, x)), DenseLinearOperator(self.task_covar()))
        )

    def posterior_mean(self, x: torch.Tensor, y: torch.Tensor, x_star: torch.Tensor) -> torch.Tensor:
        n, T = y.shape
        alpha = solve(self.train_operator(x), y.reshape(n * T)[:, None])  # (nT, 1)
        return (self._cross_covar(x_star, x) @ alpha).reshape(x_star.shape[0], T)

    def posterior(self, x: torch.Tensor, y: torch.Tensor, x_star: torch.Tensor, *, generator=None):
        """The predictive mean and each task's latent variance at ``x_star``
        by LOVE (``models/gp.py`` ``love_posterior``): the (mT, nT) cross
        block is applied through the Kronecker sweep, never formed.
        ``generator`` draws the Lanczos start where a Lanczos root runs."""
        n, T = y.shape
        m = x_star.shape[0]
        K = self.train_operator(x)
        # the RBF data kernel is stationary: its prior diagonal is the outputscale
        data_diag = _softplus(self.raw_outputscale).expand(m)
        prior_diag = torch.kron(data_diag, torch.diagonal(self.task_covar()))
        mean, var = love_posterior(
            K, self._cross_covar(x_star, x), y.reshape(n * T), prior_diag, generator=generator
        )
        return mean.reshape(m, T), var.reshape(m, T)


__all__ = ["MultitaskGPParams", "MultitaskGPRegression"]
