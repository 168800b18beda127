"""``solve`` (counterpart of linear_operator_tpu/functions/_solve.py).

Dispatch: the operator's structural solve if it has one, dense Cholesky below
``max_cholesky_size`` (or with fast solves off), preconditioned CG otherwise.

Backward (the JAX package's ``_solve_bwd``): with x = K^{-1} rhs and
cotangent g, w = K^{-T} g is one more solve, rhs gets w, and the operator's
tensors get the gradient of ``sum(-w * (K @ x))`` through one
``_bilinear_derivative``.
"""

from __future__ import annotations

import torch

from .. import settings


def _dispatch_solve(op, rhs: torch.Tensor) -> torch.Tensor:
    s = op._solve_structure(rhs)
    if s is not None:
        return s
    if settings.use_cholesky_for_solves(op.shape[-1]):
        return op._cholesky_impl(upper=False)._cholesky_solve(rhs)
    closure, _, _ = op._preconditioner()
    return op._solve_via_cg(rhs, preconditioner=closure).solution


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a cotangent back to the (possibly broadcast) primal shape."""
    if g.shape == tuple(shape):
        return g
    extra = g.ndim - len(shape)
    if extra > 0:
        g = torch.sum(g, dim=tuple(range(extra)))
    dims = tuple(i for i, (gs, ps) in enumerate(zip(g.shape, shape)) if ps == 1 and gs != 1)
    if dims:
        g = torch.sum(g, dim=dims, keepdim=True)
    return g


class _Solve(torch.autograd.Function):
    """K^{-1} rhs; the operator's tensors ride along as inputs, so that the
    backward hands each its gradient."""

    @staticmethod
    def forward(ctx, op, rhs, *op_leaves):
        x = _dispatch_solve(op, rhs)
        ctx.op = op
        ctx.rhs_shape = rhs.shape
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = _dispatch_solve(ctx.op.mT, g)
        # K_bar = -w x^T, exact for any leaf parameterization
        op_grads = ctx.op._bilinear_derivative(-w, x)
        rhs_bar = _unbroadcast(w, ctx.rhs_shape) if ctx.needs_input_grad[1] else None
        return (None, rhs_bar, *op_grads)


def solve_base(op, rhs: torch.Tensor) -> torch.Tensor:
    """K^{-1} rhs for a matrix rhs (*b, n, t), differentiable in rhs and in
    the operator's tensors: the primitive under :func:`solve`."""
    return _Solve.apply(op, rhs, *op._leaves())


def solve(op, rhs: torch.Tensor, lhs: torch.Tensor | None = None, *, factored=None) -> torch.Tensor:
    """K^{-1} rhs for a vector (n,) or matrix (*b, n, t) rhs; with ``lhs``,
    lhs @ K^{-1} rhs.  ``factored``, a factorization of ``op`` computed
    before (``op.cholesky()``, a root decomposition), routes the solve
    through its closed form instead of factorizing again."""
    if factored is not None:
        op = op.with_factorization(factored)
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    if settings.debug.on():
        if not op.is_square:
            raise RuntimeError("solve requires a square operator")
        if rhs.shape[-2] != op.shape[-1]:
            raise RuntimeError(f"rhs shape {tuple(rhs.shape)} incompatible with operator {op.shape}")
    x = solve_base(op, rhs)
    if squeeze:
        x = x[..., 0]
    return x if lhs is None else lhs @ x
