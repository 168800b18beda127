"""Beta feature flags (counterpart of linear_operator_tpu/beta_features.py).

``default_preconditioner``: when on, an operator without a preconditioner of
its own gets a randomized low-rank (rangefinder) plus diagonal one, in the
base class's ``_preconditioner``.
"""

from __future__ import annotations

import torch

from .settings import _feature_flag


class default_preconditioner(_feature_flag):
    _default = False


def build_default_preconditioner(op, *, rank: int = 15, generator: torch.Generator | None = None):
    """P = (Q Q^T K Q Q^T) + a diagonal floor, from a rank-``rank`` range
    sketch Q of K; returns (closure, precond_op, logdet_p) as
    ``_preconditioner`` does.  ``generator`` draws the sketch (a fixed CPU
    one, seed 0, when None: the JAX package's PRNGKey(0))."""
    from .operators.dense import DenseLinearOperator
    from .operators.low_rank_root_added_diag import woodbury_solve_closure
    from .operators.root import LowRankRootLinearOperator
    from .utils.cholesky import highest_matmul_precision
    from .utils.random import randn

    n = op.shape[-1]
    omega = randn((*op.batch_shape, n, rank), op.dtype, op.device, generator)
    with highest_matmul_precision():
        q, _ = torch.linalg.qr(op._matmul(omega))
        small = q.mT @ op._matmul(q)  # Q^T K Q
        evals, evecs = torch.linalg.eigh((small + small.mT) / 2)
        evals = torch.clamp(evals, min=0.0)
        root = q @ (evecs * torch.sqrt(evals)[..., None, :])  # (*b, n, rank)
    diag_floor = torch.clamp(op._diagonal() - torch.sum(root * root, dim=-1), min=1e-6)
    closure, logdet_p = woodbury_solve_closure(root, diag_floor)
    precond_op = LowRankRootLinearOperator(DenseLinearOperator(root)).add_diagonal(diag_floor)
    return closure, precond_op, logdet_p
