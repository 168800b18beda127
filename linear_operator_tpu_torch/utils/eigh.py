"""Degeneracy-safe differentiable symmetric eigendecomposition (counterpart of
linear_operator_tpu/utils/eigh.py).

``torch.linalg.eigh``'s backward contains 1/(lambda_j - lambda_i) factors
that go NaN for (near-)repeated eigenvalues.  For functions that are
invariant to rotations within a degenerate eigenspace (solves, logdets,
quadratic forms: everything this library builds from eigh), the
within-block rotation component of the eigenvector derivative is pure gauge:
zeroing it gives the correct total derivative instead of NaN.
"""

from __future__ import annotations

import torch


class _EighSafe(torch.autograd.Function):
    """The JAX package's custom JVP, transposed: with F_ij = 1 / (w_j - w_i)
    where the gap exceeds 1e-12 of max|w| (0 elsewhere, the diagonal
    included) and G = V (diag(w_bar) + F o (V^T V_bar)) V^T, the input's
    gradient is sym(G)."""

    @staticmethod
    def forward(ctx, a):
        w, v = torch.linalg.eigh(a)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, w_bar, v_bar):
        w, v = ctx.saved_tensors
        diff = w[..., None, :] - w[..., :, None]  # lambda_j - lambda_i
        scale = torch.amax(torch.abs(w), dim=-1, keepdim=True)[..., None]
        safe = torch.abs(diff) > 1e-12 * (scale + 1e-30)
        f = torch.where(safe, 1.0 / torch.where(safe, diff, 1.0), 0.0)
        inner = f * (v.mT @ v_bar) + torch.diag_embed(w_bar)
        g = v @ inner @ v.mT
        return 0.5 * (g + g.mT)


def eigh_safe(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Like ``torch.linalg.eigh`` (ascending eigenvalues) with a backward
    that is finite under degenerate eigenvalues (gauge term zeroed)."""
    return _EighSafe.apply(a)
