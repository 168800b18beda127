"""``inv_quad_logdet``: the GP marginal-likelihood core (counterpart of
linear_operator_tpu/functions/_inv_quad_logdet.py).

Stochastic path: draw m probes from the preconditioner's distribution
N(0, P) (or N(0, I) without one), run ONE batched preconditioned CG over the
stacked columns [probes | rhs] with tridiagonal extraction on the probe
columns, then

    logdet   ~= SLQ estimate of log det(P^{-1} K) + log det P
    inv_quad  = sum(solves[..., m:] * rhs)

Backward (the JAX package's ``_stochastic_bwd``), from the forward's solves
with no further CG:

    d logdet   ~= 1/m sum_j |z_j|^2 <K^{-1} z^_j, dK P^{-1} z^_j>
    d inv_quad  = -<K^{-1} rhs, dK K^{-1} rhs>,   d/d rhs = 2 K^{-1} rhs

(z^ the unit-normalized probes) as ONE ``_bilinear_derivative`` over the
stacked left and right vectors.  The preconditioner is built on the detached
operator: its terms cancel in expectation.  The Cholesky path differentiates
through autograd.

Dispatch: structural closed forms first, dense Cholesky below
``max_cholesky_size`` or with fast log_prob off, stochastic CG + SLQ above.
"""

from __future__ import annotations

import warnings

import torch

from .. import settings
from ..solvers.lanczos import lanczos_tridiag_to_diag
from ..solvers.stochastic_lq import slq_quadrature
from ..utils.random import randn
from ._solve import _unbroadcast


def inv_quad_logdet(
    op,
    inv_quad_rhs: torch.Tensor | None = None,
    logdet: bool = False,
    reduce_inv_quad: bool = True,
    *,
    generator: torch.Generator | None = None,
    num_probes: int | None = None,
    factored=None,
):
    """(inv_quad, logdet); each is zeros(batch) when not requested.

    ``generator`` draws the probes (on its own device); without one, a fixed
    seed is used and successive calls share probes.  ``factored`` reuses a
    factorization of ``op`` (see ``solve``)."""
    if factored is not None:
        op = op.with_factorization(factored)
    squeeze = inv_quad_rhs is not None and inv_quad_rhs.ndim == 1
    rhs = inv_quad_rhs[:, None] if squeeze else inv_quad_rhs
    if settings.debug.on():
        if not op.is_square:
            raise RuntimeError("inv_quad_logdet requires a square operator")
        if rhs is not None and rhs.shape[-2] != op.shape[-1]:
            raise RuntimeError(f"rhs shape {tuple(rhs.shape)} incompatible with operator {op.shape}")

    def _out(iq, ld):
        iq, ld = _finish(op, iq, ld, rhs, reduce_inv_quad)
        if squeeze and not reduce_inv_quad:
            iq = iq[..., 0]
        return iq, ld

    structural = op._inv_quad_logdet_structure(rhs, logdet)
    if structural is not None:
        return _out(*structural)

    n = op.shape[-1]
    zeros = torch.zeros(op.batch_shape, dtype=op.dtype, device=op.device)
    if settings.use_cholesky_for_log_prob(n):
        chol = op._cholesky_impl(upper=False)
        return _out(*chol_iqld(chol, rhs, logdet, zeros))

    # ---- stochastic CG + SLQ path ----------------------------------------
    if num_probes is None:
        num_probes = settings.num_trace_samples.value() if logdet else 0
    if generator is None:
        if num_probes > 0 and settings.deterministic_probes.off():
            warnings.warn(
                "inv_quad_logdet called without generator=: probe vectors are "
                "deterministic and shared across calls. Pass generator= for fresh "
                "probes, or enable settings.deterministic_probes to silence this.",
                UserWarning,
                stacklevel=3,
            )
        generator = torch.Generator().manual_seed(0)

    closure = None
    logdet_p = zeros
    if num_probes > 0:
        closure, precond_op, logdet_p = op.detach()._preconditioner()
        if precond_op is not None:
            probes = precond_op.zero_mean_mvn_samples(num_probes, generator=generator).movedim(0, -1)
            precond_probes = closure(probes)  # (*b, n, m)
        else:
            probes = randn((*op.batch_shape, n, num_probes), op.dtype, op.device, generator)
            precond_probes = probes
            logdet_p = zeros
        norms = torch.linalg.norm(probes, dim=-2, keepdim=True)  # (*b, 1, m)
        probes = probes / norms
        precond_probes = precond_probes / norms
    else:
        probes = torch.zeros((*op.batch_shape, n, 0), dtype=op.dtype, device=op.device)
        precond_probes = probes
        norms = torch.zeros((*op.batch_shape, 1, 0), dtype=op.dtype, device=op.device)

    iq, ld_est = _stochastic_iqld(op, rhs, probes, precond_probes, norms, preconditioner=closure)
    # under skip_logdet_forward the SLQ term is zero but log det P is kept
    ld = ld_est + logdet_p if logdet else zeros
    return _out(iq, ld)


def chol_iqld(chol, rhs, logdet: bool, zeros: torch.Tensor):
    """Cholesky-path inv_quad_logdet from the lower factor ``chol``."""
    if rhs is None:
        iq = zeros
    else:
        y = chol._solve_structure(rhs)
        iq = torch.sum(y * y, dim=-2)
    ld = 2.0 * torch.sum(torch.log(torch.abs(chol._diagonal())), dim=-1) if logdet else zeros
    return iq, ld


def _finish(op, iq, ld, rhs, reduce_inv_quad):
    if rhs is None:
        iq = torch.zeros(op.batch_shape, dtype=op.dtype, device=op.device)
    elif reduce_inv_quad:
        iq = torch.sum(iq, dim=-1)
    # ld carries the joint batch when the rhs batch is broader than the op's
    ld = ld.expand(torch.broadcast_shapes(op.batch_shape, ld.shape))
    return iq, ld


# ---------------------------------------------------------------------------
# Stochastic CG + SLQ core
# ---------------------------------------------------------------------------


class _StochasticIQLD(torch.autograd.Function):
    """(inv_quad, SLQ logdet) from given probes.  The operator's tensors ride
    along as inputs, so that the backward hands each its gradient."""

    @staticmethod
    def forward(ctx, op, rhs, probes, precond_probes, norms, preconditioner, *op_leaves):
        iq, ld, probe_solves, rhs_solves = _stochastic_forward(op, rhs, probes, preconditioner)
        ctx.op = op
        ctx.rhs_shape = None if rhs is None else rhs.shape
        ctx.save_for_backward(probe_solves, rhs_solves, precond_probes, norms)
        return iq, ld

    @staticmethod
    def backward(ctx, iq_bar, ld_bar):
        probe_solves, rhs_solves, precond_probes, norms = ctx.saved_tensors
        m = probe_solves.shape[-1]
        lefts, rights = [], []
        if m > 0:
            # the solves may carry a joint batch broader than the probes'
            joint = probe_solves.shape[:-2]
            coef = ld_bar[..., None, None] * norms**2 / m  # (*b, 1, m)
            lefts.append(probe_solves * coef)
            rights.append(precond_probes.expand(*joint, *precond_probes.shape[-2:]))
        if rhs_solves is not None and rhs_solves.shape[-1] > 0:
            lefts.append(-rhs_solves * iq_bar[..., None, :])
            rights.append(rhs_solves)
        if lefts:
            op_grads = ctx.op._bilinear_derivative(torch.cat(lefts, dim=-1), torch.cat(rights, dim=-1))
        else:
            op_grads = (None,) * len(list(ctx.op._leaves()))
        rhs_bar = None
        if ctx.rhs_shape is not None and ctx.needs_input_grad[1]:
            rhs_bar = _unbroadcast(2.0 * rhs_solves * iq_bar[..., None, :], ctx.rhs_shape)
        return (None, rhs_bar, None, None, None, None, *op_grads)


def _stochastic_iqld(op, rhs, probes, precond_probes, norms, *, preconditioner=None):
    """Stochastic (inv_quad, logdet) on given unit-norm probes (*b, n, m).
    ``preconditioner`` is the closure the probes were drawn with; None
    rebuilds it from the operator."""
    return _StochasticIQLD.apply(
        op, rhs, probes, precond_probes, norms, preconditioner, *op._leaves()
    )


def _stochastic_forward(op, rhs, probes, preconditioner=None):
    n = op.shape[-1]
    m = probes.shape[-1]
    if rhs is not None and m > 0:
        joint = torch.broadcast_shapes(op.batch_shape, rhs.shape[:-2], probes.shape[:-2])
        stacked = torch.cat(
            [probes.expand(*joint, *probes.shape[-2:]), rhs.expand(*joint, *rhs.shape[-2:])], dim=-1
        )
    elif rhs is not None:
        stacked = rhs
    else:
        stacked = probes

    if preconditioner is None:
        preconditioner, _, _ = op.detach()._preconditioner()
    result = op._solve_via_cg(stacked, preconditioner=preconditioner, n_tridiag=m)
    solves = result.solution

    zeros = torch.zeros(op.batch_shape, dtype=op.dtype, device=op.device)
    if m > 0 and settings.skip_logdet_forward.on():
        ld = zeros
    elif m > 0:
        # a NaN anywhere in the tridiagonals means the solve failed: return a
        # NaN logdet rather than quadrature garbage
        t_mats = result.t_mats
        bad = torch.isnan(t_mats).any()
        eye = torch.eye(t_mats.shape[-1], dtype=t_mats.dtype, device=t_mats.device)
        evals, evecs = lanczos_tridiag_to_diag(torch.where(bad, eye, t_mats))
        (ld,) = slq_quadrature(n, evals, evecs, [torch.log])
        ld = torch.where(bad, torch.nan, ld)
    else:
        ld = zeros

    if rhs is not None:
        rhs_solves = solves[..., m:]
        iq = torch.sum(rhs_solves * stacked[..., m:], dim=-2)
    else:
        rhs_solves = None
        iq = torch.zeros_like(zeros)
    return iq, ld, solves[..., :m], rhs_solves
