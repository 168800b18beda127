"""``solve``, forward only (counterpart of
linear_operator_tpu/functions/_solve.py).

Dispatch: the operator's structural solve if it has one, dense Cholesky below
``max_cholesky_size`` (or with fast solves off), preconditioned CG otherwise.
"""

from __future__ import annotations

import torch

from .. import settings

BACKWARD_SLICE = (
    "the backward of solve and inv_quad_logdet (the _stochastic_bwd / "
    "_bilinear_derivative path, with the fused K2 kernel) is the next slice "
    "of the port, the GP training step; this slice is forward-only"
)


def _dispatch_solve(op, rhs: torch.Tensor) -> torch.Tensor:
    s = op._solve_structure(rhs)
    if s is not None:
        return s
    if settings.use_cholesky_for_solves(op.shape[-1]):
        return op._cholesky_impl(upper=False)._cholesky_solve(rhs)
    closure, _, _ = op._preconditioner()
    return op._solve_via_cg(rhs, preconditioner=closure).solution


class _Solve(torch.autograd.Function):
    """K^{-1} rhs; the operator's tensors ride along as inputs so that a
    backward reaches this node and raises."""

    @staticmethod
    def forward(ctx, op, rhs, *op_leaves):
        return _dispatch_solve(op, rhs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(BACKWARD_SLICE)


def solve(op, rhs: torch.Tensor, lhs: torch.Tensor | None = None) -> torch.Tensor:
    """K^{-1} rhs for a vector (n,) or matrix (*b, n, t) rhs; with ``lhs``,
    lhs @ K^{-1} rhs."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    if settings.debug.on():
        if not op.is_square:
            raise RuntimeError("solve requires a square operator")
        if rhs.shape[-2] != op.shape[-1]:
            raise RuntimeError(f"rhs shape {tuple(rhs.shape)} incompatible with operator {op.shape}")
    x = _Solve.apply(op, rhs, *op._leaves())
    if squeeze:
        x = x[..., 0]
    return x if lhs is None else lhs @ x
