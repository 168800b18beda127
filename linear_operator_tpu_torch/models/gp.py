"""Exact GP regression on the operator engine (counterpart of
linear_operator_tpu/models/gp.py).

K = k(X, X) + noise I as a lazy KernelLinearOperator plus a constant
diagonal, and

    -2 log p(y) = y^T K^{-1} y + log|K| + n log 2 pi

from ``inv_quad_logdet``: Cholesky below the size cutoff, preconditioned CG
+ SLQ above it.  Forward only in this slice of the port.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..functions import inv_quad_logdet, solve
from ..operators.kernel import KernelLinearOperator, rbf_covar, rbf_fused_matvec
from ..utils.cholesky import highest_matmul_precision


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus(x) + 1e-6; torch's softplus turns linear above 20
    return torch.logaddexp(x, torch.zeros_like(x)) + 1e-6


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
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExactGPRegression runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
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


def load_jax_params(model: ExactGPRegression, params) -> ExactGPRegression:
    """Fill ``model``'s parameters from the JAX package's ``GPParams`` (of
    numpy or JAX arrays) or a mapping with the same field names."""
    fields = params if isinstance(params, Mapping) else params._asdict()
    for name in ("raw_lengthscale", "raw_outputscale", "raw_noise"):
        old = getattr(model, name)
        value = torch.tensor(np.array(fields[name]), dtype=old.dtype, device=old.device)
        setattr(model, name, nn.Parameter(value))
    return model
