"""K^{-1/2} rhs and K^{1/2} rhs by contour integral quadrature (counterpart
of linear_operator_tpu/functions/_sqrt_inv_matmul.py).

Forward: K^{-1/2} rhs = sum_j w_j (K + s_j I)^{-1} rhs, the shifted solves
sharing one MINRES recurrence.  Backward, from d(K + s)^{-1} =
-(K + s)^{-1} dK (K + s)^{-1} and the saved quadrature:

    rhs_bar = K^{-1/2} g            (the same shifts and weights on g)
    K_bar   = -sum_j w_j ((K + s_j)^{-1} g) ((K + s_j)^{-1} rhs)^T

the latter as ONE ``_bilinear_derivative`` over the stacked shifted solves.

With the operator's preconditioner P active, the solves become
(K + s_j P)^{-1} P^{1/2} rhs, and the weighted sum is M rhs with
M M^T = K^{-1} exactly (not the symmetric K^{-1/2} rhs); P^{1/2} is a nested
quadrature on the preconditioner's own operator.  P is built on the detached
operator, so the gradient treats it as a constant, as the JAX package does.

Randomness: one Lanczos start vector is drawn per call and serves the range
estimate and the nested quadrature on P; the backward reuses the forward's
shifts and weights, and the settings the forward read.

On a row-sharded operator (``parallel/``) rhs, the result and its
cotangent are the rank's rows and the start vector is drawn whole and cut
to them; the range estimate and MINRES sum their inner products over the
model group (``contour_integral_quad``'s ``layout``), on K and on P's own
operator (whose products sum L_R^T v_R), and the backward sums the
operator's gradient shares once, as ``solve``'s does.
"""

from __future__ import annotations

import torch

from .. import settings
from ..solvers.contour_integral_quad import contour_integral_quad
from ..utils.random import randn


def _weighted_sum(weights: torch.Tensor, solves: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights.reshape(-1, *([1] * (solves.ndim - 1))) * solves, dim=0)


class _Quadrature:
    """What one call's forward fixes for its backward: the start vector, the
    settings read at entry, and the preconditioner's pieces (P^{-1} and
    P^{1/2}), from the detached operator."""

    def __init__(self, op, init: torch.Tensor):
        self.init = init
        self.layout = _row_layout(op)
        self.kw = dict(
            num_quad=settings.num_contour_quadrature.value(),
            max_lanczos_iter=settings.max_lanczos_quadrature_iterations.value(),
            tolerance=settings.minres_tolerance.value(),
            max_iter=settings.max_cg_iterations.value(),
            layout=self.layout,
        )
        self.precond, self.sqrt_pre = None, None
        closure, precond_op, _ = op.detach()._preconditioner()
        if closure is not None and precond_op is not None:
            self.precond = closure

            def sqrt_pre(r: torch.Tensor) -> torch.Tensor:
                solves, _, weights = contour_integral_quad(
                    precond_op._matmul, r, init=init, inverse=False, **self.kw
                )
                return _weighted_sum(weights, solves)

            self.sqrt_pre = sqrt_pre

    def apply(self, op, rhs: torch.Tensor, quadrature=None, premultiply: bool = True):
        """(sum_j w_j solves_j, solves, (shifts, weights))."""
        solves, shifts, weights = contour_integral_quad(
            op._matmul,
            rhs,
            init=self.init,
            preconditioner=self.precond,
            sqrt_premultiply=self.sqrt_pre if premultiply else None,
            quadrature=quadrature,
            **self.kw,
        )
        return _weighted_sum(weights, solves), solves, (shifts, weights)


class _SqrtInvMatmul(torch.autograd.Function):
    """M rhs (K^{-1/2} rhs without a preconditioner); the operator's tensors
    ride along as inputs, so that the backward hands each its gradient."""

    @staticmethod
    def forward(ctx, op, rhs, quad, *op_leaves):
        out, solves, quadrature = quad.apply(op, rhs)
        ctx.op, ctx.quad, ctx.quadrature = op, quad, quadrature
        ctx.save_for_backward(solves)
        return out

    @staticmethod
    def backward(ctx, g):
        (rhs_solves,) = ctx.saved_tensors
        quad = ctx.quad
        # out = sum_j w_j S_j P^{1/2} rhs with S_j = (K + s_j P)^{-1}
        # symmetric, so the cotangent's solves run WITHOUT the premultiply,
        # which comes after them: rhs_bar = P^{1/2} sum_j w_j S_j g
        g_out, g_solves, _ = quad.apply(ctx.op, g.contiguous(), quadrature=ctx.quadrature, premultiply=False)
        rhs_bar = None
        if ctx.needs_input_grad[1]:
            rhs_bar = quad.sqrt_pre(g_out) if quad.sqrt_pre is not None else g_out
        _, weights = ctx.quadrature
        w = weights.reshape(-1, *([1] * (g_solves.ndim - 1)))
        # the shifts stacked into columns: (*b, n, t * q)
        left = (-w * g_solves).movedim(0, -1).reshape(*g_solves.shape[1:-1], -1)
        right = rhs_solves.movedim(0, -1).reshape(*rhs_solves.shape[1:-1], -1)
        op_grads = ctx.op._bilinear_derivative(left, right)
        if quad.layout is not None:
            op_grads = quad.layout.reduce_grads(op_grads)
        return (None, rhs_bar, None, *op_grads)


def _broadcast_rhs(op, rhs: torch.Tensor) -> torch.Tensor:
    """rhs broadcast to the joint batch of the operator and itself (the start
    vector takes its batch from it; the backward sums back)."""
    batch = torch.broadcast_shapes(op.batch_shape, rhs.shape[:-2])
    return rhs.expand(*batch, *rhs.shape[-2:])


def _row_layout(op):
    """A row-sharded operator's ``SolveLayout``, else None."""
    if getattr(op, "row_group", None) is None:
        return None
    from ..parallel.sharding import solve_layout

    return solve_layout(op)


def _sqrt_inv_core(op, rhs: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    if _row_layout(op) is None:
        init = randn((*rhs.shape[:-2], rhs.shape[-2]), rhs.dtype, rhs.device, generator)  # the Lanczos start
    else:
        from ._root_decomposition import _random_start

        # the rank's rows of the whole start vector
        init = _random_start(op, generator).to(rhs.dtype)
        init = init.expand(*rhs.shape[:-2], init.shape[-1])
    return _SqrtInvMatmul.apply(op, rhs, _Quadrature(op, init), *op._leaves())


def sqrt_inv_matmul(op, rhs: torch.Tensor, lhs: torch.Tensor | None = None, *, generator=None):
    """K^{-1/2} rhs (M rhs with M M^T = K^{-1} under an active
    preconditioner); with ``lhs``, (lhs @ K^{-1/2} rhs, the row-wise
    lhs K^{-1} lhs^T, through ``inv_quad``)."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    out = _sqrt_inv_core(op, _broadcast_rhs(op, rhs), generator)
    if squeeze:
        out = out[..., 0]
    if lhs is not None:
        from . import inv_quad

        iq = inv_quad(op, lhs.mT, reduce_inv_quad=False)
        return lhs @ out, iq
    return out


class _RowMatmul(torch.autograd.Function):
    """K v on a row-sharded operator (the rank's rows of both), whose
    products gather or sum outside autograd: the backward is K g (K is
    symmetric) for v, and the operator's gradient shares of sum(g * K v),
    summed once over the model group."""

    @staticmethod
    def forward(ctx, op, layout, rhs, *op_leaves):
        ctx.op, ctx.layout = op, layout
        ctx.save_for_backward(rhs)
        return op._matmul(rhs)

    @staticmethod
    def backward(ctx, g):
        (rhs,) = ctx.saved_tensors
        grads = ctx.layout.reduce_grads(ctx.op._bilinear_derivative(g, rhs))
        rhs_bar = ctx.op._matmul(g) if ctx.needs_input_grad[2] else None
        return (None, None, rhs_bar, *grads)


def sqrt_matmul(op, rhs: torch.Tensor, *, generator=None) -> torch.Tensor:
    """K^{1/2} rhs = K (K^{-1/2} rhs): with M M^T = K^{-1}, (K M)(K M)^T = K,
    so K M z is an exact N(0, K) draw for z ~ N(0, I)."""
    half_inv = _sqrt_inv_core(op, _broadcast_rhs(op, rhs), generator)
    layout = _row_layout(op)
    if layout is None:
        return op._matmul(half_inv)
    return _RowMatmul.apply(op, layout, half_inv, *op._leaves())
