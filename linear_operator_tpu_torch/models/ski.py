"""SKI / KISS-GP: structured kernel interpolation onto a regular grid
(counterpart of linear_operator_tpu/models/ski.py; Wilson & Nickisch 2015).

    K_SKI = W K_grid W^T,   K_grid = (x)_d Toeplitz_d   (a product kernel)

W holds 2^D linear (or 4^D cubic) interpolation weights a point, and the
grid kernel's mat-vec is a Kronecker sweep of Toeplitz products: an
O(n 2^D + M log M) mat-vec, so CG and SLQ reach hundreds of thousands of
points.  The model is an ``nn.Module`` whose three raw parameters (and so the
computation) live on ``device``: "cuda" unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..functions import inv_quad_logdet, solve
from ..operators import GridInterpolatedLinearOperator, KroneckerProductLinearOperator, ToeplitzLinearOperator
from ..utils.sparse import flatten_grid_interp
from .gp import _softplus, love_posterior, model_device


class GridSpec(NamedTuple):
    mins: torch.Tensor  # (D,)
    maxs: torch.Tensor  # (D,)
    sizes: tuple  # (D,) ints


class SKIParams(NamedTuple):
    """The JAX package's parameter tuple; ``load_jax_params`` takes one (of
    numpy or JAX arrays) into a model's parameters."""

    raw_lengthscale: object  # (D,)
    raw_outputscale: object
    raw_noise: object


def make_grid(x: torch.Tensor, sizes: Sequence[int], pad: float = 0.1) -> GridSpec:
    """A grid over the data's bounding box, widened by ``pad`` of its span on
    each side."""
    mins = torch.amin(x, dim=0)
    maxs = torch.amax(x, dim=0)
    span = torch.clamp_min(maxs - mins, 1e-6)
    return GridSpec(mins - pad * span, maxs + pad * span, tuple(int(s) for s in sizes))


def load_jax_grid(grid) -> GridSpec:
    """The JAX package's ``GridSpec`` (of numpy or JAX arrays) as a GridSpec
    of float64 CPU tensors; the model moves it to its own dtype and device."""
    return GridSpec(
        torch.tensor(np.array(grid.mins), dtype=torch.float64),
        torch.tensor(np.array(grid.maxs), dtype=torch.float64),
        tuple(int(s) for s in grid.sizes),
    )


def _grid_position(x: torch.Tensor, grid: GridSpec, d: int) -> torch.Tensor:
    """Point coordinates along dim d in grid steps, clipped into the grid."""
    m = grid.sizes[d]
    h = (grid.maxs[d] - grid.mins[d]) / (m - 1)
    return torch.clamp((x[:, d] - grid.mins[d]) / h, 0.0, m - 1 - 1e-6)


def linear_interp_weights_per_dim(x: torch.Tensor, grid: GridSpec):
    """Per-dimension linear interpolation stencils: tuples of (n, 2) indices
    and weights."""
    idx_list, w_list = [], []
    for d in range(x.shape[-1]):
        pos = _grid_position(x, grid, d)
        i0 = torch.floor(pos)
        frac = pos - i0
        i0 = i0.to(torch.int64)
        idx_list.append(torch.stack([i0, i0 + 1], dim=-1))
        w_list.append(torch.stack([1.0 - frac, frac], dim=-1))
    return tuple(idx_list), tuple(w_list)


def _keys(s: torch.Tensor) -> torch.Tensor:
    """The cubic convolution kernel of Keys (1981), a = -0.5."""
    s = torch.abs(s)
    near = (1.5 * s - 2.5) * s * s + 1.0
    far = ((-0.5 * s + 2.5) * s - 4.0) * s + 2.0
    return torch.where(s <= 1.0, near, torch.where(s < 2.0, far, torch.zeros_like(s)))


def cubic_interp_weights_per_dim(x: torch.Tensor, grid: GridSpec):
    """Per-dimension cubic-convolution stencils: (n, 4) each.

    The weights on the unclamped stencil floor-1 .. floor+2 sum to 1; only
    the indices clamp to the grid, so a boundary stencil repeats an index
    and its entries add (both routes sum them)."""
    idx_list, w_list = [], []
    for d in range(x.shape[-1]):
        m = grid.sizes[d]
        pos = _grid_position(x, grid, d)
        i0 = torch.floor(pos)
        offsets = torch.arange(-1, 3, dtype=pos.dtype, device=pos.device)
        pts = i0[:, None] + offsets[None, :]  # (n, 4), unclamped
        w_list.append(_keys(pos[:, None] - pts))
        idx_list.append(torch.clamp(pts, 0, m - 1).to(torch.int64))
    return tuple(idx_list), tuple(w_list)


def linear_interp_weights(x: torch.Tensor, grid: GridSpec):
    """Per-point 2^D linear interpolation (indices, values) over the flat
    row-major grid: (n, D) -> (n, 2^D) each."""
    idx_list, w_list = linear_interp_weights_per_dim(x, grid)
    return flatten_grid_interp(idx_list, w_list, grid.sizes)


def rbf_toeplitz_column(m: int, h, lengthscale, dtype=torch.float32) -> torch.Tensor:
    """First column of the 1-d RBF kernel on a regular grid of spacing h."""
    device = lengthscale.device if isinstance(lengthscale, torch.Tensor) else None
    dist = torch.arange(m, dtype=dtype, device=device) * h
    return torch.exp(-0.5 * (dist / lengthscale) ** 2)


class SKIGPRegression(nn.Module):
    """KISS-GP regression with an RBF product kernel on a regular grid.

    ``interp``: "linear" (2-point stencils) or "cubic" (4-point Keys
    stencils, Wilson & Nickisch's choice: a much smaller interpolation error
    on coarse grids for ~2x the cost of W).  The parameters are the
    lengthscales (one a dimension), the outputscale and the noise, each
    through a softplus."""

    def __init__(
        self,
        grid: GridSpec,
        interp: str = "linear",
        *,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        if interp not in ("linear", "cubic"):
            raise ValueError(f"unknown interp {interp!r}")
        device = model_device(device, "SKIGPRegression")
        kw = dict(dtype=dtype, device=device)
        self.grid = GridSpec(
            torch.as_tensor(grid.mins).to(**kw), torch.as_tensor(grid.maxs).to(**kw), tuple(int(s) for s in grid.sizes)
        )
        self.interp = interp
        self.raw_lengthscale = nn.Parameter(torch.zeros((len(self.grid.sizes),), **kw))
        self.raw_outputscale = nn.Parameter(torch.zeros((), **kw))
        self.raw_noise = nn.Parameter(torch.full((), -2.0, **kw))

    def _interp_weights_per_dim(self, x):
        if self.interp == "cubic":
            return cubic_interp_weights_per_dim(x, self.grid)
        return linear_interp_weights_per_dim(x, self.grid)

    def grid_operator(self):
        """The grid kernel: a Kronecker product of one Toeplitz factor a
        dimension, the outputscale folded into the first."""
        ls = _softplus(self.raw_lengthscale)
        factors = []
        for d, m in enumerate(self.grid.sizes):
            h = (self.grid.maxs[d] - self.grid.mins[d]) / (m - 1)
            col = rbf_toeplitz_column(m, h, ls[d], dtype=self.raw_outputscale.dtype)
            if d == 0:
                col = col * _softplus(self.raw_outputscale)
            factors.append(ToeplitzLinearOperator(col))
        return factors[0] if len(factors) == 1 else KroneckerProductLinearOperator(tuple(factors))

    def covariance(self, x1, x2=None):
        """W_1 K_grid W_2^T, the stencils flattened once for the call."""
        k_grid = self.grid_operator()
        li, lv = self._interp_weights_per_dim(x1)
        ri, rv = (li, lv) if x2 is None else self._interp_weights_per_dim(x2)
        lv = tuple(v.to(k_grid.dtype) for v in lv)
        rv = tuple(v.to(k_grid.dtype) for v in rv)
        return GridInterpolatedLinearOperator(k_grid, li, lv, ri, rv, self.grid.sizes)

    def train_operator(self, x):
        return self.covariance(x).add_diagonal(_softplus(self.raw_noise))

    def neg_mll(self, x, y, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """Negative marginal log-likelihood, averaged over data points;
        ``generator`` draws the probes."""
        n = y.shape[-1]
        iq, ld = inv_quad_logdet(self.train_operator(x), y[..., None], logdet=True, generator=generator)
        return 0.5 * torch.mean(iq + ld + n * math.log(2.0 * math.pi)) / n

    def posterior_mean(self, x, y, x_star):
        alpha = solve(self.train_operator(x), y[..., None])
        return (self.covariance(x_star, x) @ alpha)[..., 0]

    def posterior(self, x, y, x_star, *, generator: torch.Generator | None = None):
        """Predictive mean and latent variance at ``x_star`` by LOVE
        (``models/gp.py`` ``love_posterior``): one solve and one Lanczos
        inverse root over the training points, then products with the lazy
        cross-covariance, never an m x n dense block.  ``generator`` draws
        the Lanczos start."""
        K = self.train_operator(x)
        k_star = self.covariance(x_star, x)
        k_ss_diag = self.covariance(x_star).diagonal()
        return love_posterior(K, k_star, y, k_ss_diag, generator=generator)
