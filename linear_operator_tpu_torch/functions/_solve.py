"""``solve`` (counterpart of linear_operator_tpu/functions/_solve.py).

Dispatch: the operator's structural solve if it has one, dense Cholesky below
``max_cholesky_size`` (or with fast solves off), preconditioned CG otherwise.

Backward (the JAX package's ``_solve_bwd``): with x = K^{-1} rhs and
cotangent g, w = K^{-T} g is one more solve, rhs gets w, and the operator's
tensors get the gradient of ``sum(-w * (K @ x))`` through one
``_bilinear_derivative``.

On a mesh (``parallel/``; ``sharding.solve_layout``) CG runs under
``SolveLayout``'s reduction for a solve, whose stopping test is global, so
that every rank runs the unsharded iterations.  On a row-sharded operator
rhs, x, g and w are the rank's rows, and w solves with ``op.mT``, the
operator itself, under the same preconditioner; the operator's gradient is
this rank's share, summed once over the model group
(``SolveLayout.reduce_grads``), and the rhs's gradient stays the rank's
rows.  A data rank's gradient is its batch's, which the caller sums over
the data axis as ``sharded_train_step`` does.
"""

from __future__ import annotations

import torch

from .. import settings


def _dispatch_solve(op, rhs: torch.Tensor) -> torch.Tensor:
    from ..parallel.sharding import solve_layout

    s = op._solve_structure(rhs)
    if s is not None:
        return s
    if settings.use_cholesky_for_solves(op.shape[-1]):
        return op._cholesky_impl(upper=False)._cholesky_solve(rhs)
    closure, _, _ = op._preconditioner()
    layout = solve_layout(op)
    reduction = None if layout is None else layout.reduction(0, 0, rhs.shape[-1], rhs)
    return op._solve_via_cg(rhs, preconditioner=closure, reduction=reduction).solution


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
        from ..parallel.sharding import solve_layout

        (x,) = ctx.saved_tensors
        w = _dispatch_solve(ctx.op.mT, g)
        # K_bar = -w x^T, exact for any leaf parameterization
        op_grads = ctx.op._bilinear_derivative(-w, x)
        layout = solve_layout(ctx.op)
        if layout is not None:
            op_grads = layout.reduce_grads(op_grads)
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
        # a row-sharded operator takes this rank's rows of the rhs
        rows = op.rows.shape[-2] if getattr(op, "row_group", None) is not None else op.shape[-1]
        if rhs.shape[-2] != rows:
            raise RuntimeError(f"rhs shape {tuple(rhs.shape)} incompatible with operator {op.shape}")
    x = solve_base(op, rhs)
    if squeeze:
        x = x[..., 0]
    return x if lhs is None else lhs @ x
