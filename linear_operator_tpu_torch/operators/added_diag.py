"""K + D for diagonal D: home of the CG preconditioner (counterpart of
linear_operator_tpu/operators/added_diag.py).

The preconditioner is P = L L^T + D with L a rank-k factor of K, applied by
the Woodbury identity, with log det P from the matrix determinant lemma.
L is the greedy pivoted Cholesky factor (``solvers/pivoted_cholesky.py``) in
the default "pivoted" mode, or a Nystrom factor in the "nystrom" and "auto"
modes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import settings
from ..utils.cholesky import highest_matmul_precision, psd_safe_cholesky
from ._linear_operator import LinearOperator
from .diag import DiagLinearOperator
from .sum import SumLinearOperator


def nystrom_factor(op: LinearOperator, rank: int) -> torch.Tensor:
    """Nystrom factor L with L L^T ~= K from uniformly strided landmark
    columns: L = K[:, idx] chol(K[idx, idx] + eps I)^{-T}.

    The landmarks are ``np.unique(np.linspace(0, n - 1, rank).round())``,
    the JAX package's choice, so both packages pick identical columns."""
    n = op.shape[-1]
    rank = min(rank, n)
    idx = np.unique(np.linspace(0, n - 1, rank).round().astype(np.int64))
    k = len(idx)
    idx_t = torch.as_tensor(idx, device=op.device)
    eye = torch.eye(k, dtype=op.dtype, device=op.device)
    with highest_matmul_precision():
        cols = op._select_cols(idx_t)._matmul(eye)  # (*b, n, k)
        kmm = cols[..., idx_t, :]  # (*b, k, k)
        kmm = 0.5 * (kmm + kmm.mT)
        eps = 1e-6 * torch.diagonal(kmm, dim1=-2, dim2=-1).mean(dim=-1)
        lmm = psd_safe_cholesky(kmm + eps[..., None, None] * eye)
        # L = cols lmm^{-T}: one triangular solve against cols^T
        lt = torch.linalg.solve_triangular(lmm, cols.mT, upper=False)  # (*b, k, n)
    return lt.mT


def auto_preconditioner_rank(n: int, k_setting: int = 15) -> int:
    """Rank for ``preconditioner_mode("auto")``: ``clip(n // 64, 50, 400)``,
    never below ``max_preconditioner_size`` and never above n."""
    return min(max(min(max(n // 64, 50), 400), k_setting), n)


class AddedDiagLinearOperator(SumLinearOperator):
    """(op, diag_op); ``precond_factor`` optionally carries a precomputed
    rank-k preconditioner factor (see :meth:`with_preconditioner`).

    ``preconditioner_override(self) -> (closure, precond_op, logdet_p)`` is a
    user's own preconditioner: when set, ``_preconditioner`` returns what it
    returns, whatever the rank and size settings."""

    def __init__(
        self, op: LinearOperator, diag_op: DiagLinearOperator, *, precond_factor=None, preconditioner_override=None
    ):
        if not isinstance(diag_op, DiagLinearOperator):
            raise TypeError("second operand must be a DiagLinearOperator")
        super().__init__((op, diag_op))
        self.precond_factor = precond_factor
        self.preconditioner_override = preconditioner_override

    @property
    def _linear_op(self) -> LinearOperator:
        return self.operators[0]

    @property
    def _diag_op(self) -> DiagLinearOperator:
        return self.operators[1]

    def __add__(self, other):
        if isinstance(other, DiagLinearOperator):
            return AddedDiagLinearOperator(self._linear_op, self._diag_op + other)
        if isinstance(other, LinearOperator):
            # the diagonal stays outside, so the sum keeps its preconditioner
            return AddedDiagLinearOperator(self._linear_op + other, self._diag_op)
        return super().__add__(other)

    def _preconditioning_off(self) -> bool:
        k = settings.max_preconditioner_size.value()
        return k == 0 or self.shape[-1] < settings.min_preconditioning_size.value()

    def with_preconditioner(self, factor: torch.Tensor | None = None):
        """The same operator carrying the preconditioner factor, built once
        under the current settings, so that later solves on it reuse the
        factor.  Returns ``self`` when preconditioning is gated off or when
        both solve and inv_quad_logdet would take the Cholesky path."""
        if factor is None:
            n = self.shape[-1]
            if self._preconditioning_off():
                return self
            if settings.use_cholesky_for_solves(n) and settings.use_cholesky_for_log_prob(n):
                return self
            # no gradient flows through the preconditioner (its terms cancel)
            factor = self.detach()._build_precond_factor()
        return self._replace(precond_factor=factor)

    def _build_precond_factor(self) -> torch.Tensor:
        k = settings.max_preconditioner_size.value()
        mode = settings.preconditioner_mode.value()
        if mode == "auto":
            rank = auto_preconditioner_rank(self.shape[-1], k)
            return nystrom_factor(self._linear_op, rank=rank)
        if mode == "nystrom":
            return nystrom_factor(self._linear_op, rank=k)
        from ..functions import pivoted_cholesky

        return pivoted_cholesky(self._linear_op, rank=k)

    def _preconditioner(self):
        """(closure, precond_op, logdet_p), or (None, None, None) when gated
        off: P^{-1} by Woodbury, log det P by the determinant lemma."""
        if self.preconditioner_override is not None:
            return self.preconditioner_override(self)
        if self._preconditioning_off():
            return None, None, None

        from .dense import DenseLinearOperator
        from .low_rank_root_added_diag import woodbury_solve_closure
        from .root import LowRankRootLinearOperator

        L = self.precond_factor
        if L is None:
            L = self._build_precond_factor()  # (*b, n, k)
        diag = self._diag_op._diagonal()  # (*b, n)
        # A factor that went NaN degrades to P = D instead of poisoning CG.
        if bool(torch.isnan(L).any()):
            from ..utils.warnings import debug_nan_check

            debug_nan_check("the preconditioner factor", L)
            L = torch.zeros_like(L)

        closure, logdet_p = woodbury_solve_closure(L, diag)
        precond_op = LowRankRootLinearOperator(DenseLinearOperator(L)).add_diagonal(diag)
        return closure, precond_op, logdet_p
