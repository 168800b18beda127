"""Kronecker product plus diagonal: (x)_i K_i + D (counterpart of
linear_operator_tpu/operators/kronecker_added_diag.py).

For constant D = c I the solve and log-determinant are exact through the
factors' eigendecompositions, K_i = Q_i L_i Q_i^T:

    (K + cI)^{-1} = ((x) Q_i) diag(kron(L_i) + c)^{-1} ((x) Q_i)^T
    log det(K + cI) = sum log(kron(L_i) + c)

The eigenvector products are Kronecker sweeps; only the O(N) eigenvalue
vector is formed.  For a Kronecker-diagonal D with matching factors the
symmetric whitening of Rakitsch et al. (2013) makes them exact as well.  An
unstructured diagonal falls back to preconditioned CG through the Kronecker
mat-vec.  Everything stays in the operator's dtype (f32 on the card), as in
the JAX package.
"""

from __future__ import annotations

import torch

from .added_diag import AddedDiagLinearOperator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator
from .kronecker import KroneckerProductDiagLinearOperator, KroneckerProductLinearOperator, _kron_vector
from .sum import SumLinearOperator


class KroneckerProductAddedDiagLinearOperator(AddedDiagLinearOperator):
    """operators = (KroneckerProductLinearOperator, a Diag or Kronecker-diag
    operator)."""

    def __init__(self, op, diag_op, *, precond_factor=None):
        if not isinstance(op, KroneckerProductLinearOperator):
            raise TypeError("first operand must be a KroneckerProductLinearOperator")
        if not isinstance(diag_op, (DiagLinearOperator, KroneckerProductDiagLinearOperator)):
            raise TypeError("second operand must be a Diag or Kronecker-diag operator")
        SumLinearOperator.__init__(self, (op, diag_op))
        self.precond_factor = precond_factor
        self.preconditioner_override = None

    @property
    def _kron(self) -> KroneckerProductLinearOperator:
        return self.operators[0]

    @property
    def _is_constant_diag(self) -> bool:
        return isinstance(self.operators[1], ConstantDiagLinearOperator)

    @property
    def _is_kron_diag(self) -> bool:
        return isinstance(self.operators[1], KroneckerProductDiagLinearOperator)

    @property
    def _whitening_shapes_match(self) -> bool:
        """Whether ``_whitened_eigen`` applies (as many diagonal factors as
        Kronecker factors, of matching sizes), without an eigh."""
        d_factors = self.operators[1].operators
        k_factors = self._kron.operators
        return len(d_factors) == len(k_factors) and all(
            kf.shape[-1] == df.shape[-1] for kf, df in zip(k_factors, d_factors)
        )

    def with_preconditioner(self, factor=None):
        """Itself when an exact path applies (a constant diagonal, or a
        Kronecker diagonal with matching factors): CG never runs there.  The
        AddedDiag machinery otherwise."""
        if self._is_constant_diag or (self._is_kron_diag and self._whitening_shapes_match):
            return self
        return super().with_preconditioner(factor)

    def _eigen(self):
        """The factors' eigendecompositions: (kron evals (*b, N), the evecs'
        Kronecker operator)."""
        return self._kron.eigh()

    def _whitened_eigen(self):
        """With D = (x) D_d:  K + D = D^{1/2} ((x)_d D_d^{-1/2} K_d D_d^{-1/2} + I) D^{1/2};
        the whitened middle is again Kronecker, so the factors' eigh gives
        exact solves and logdets.  (evals, evecs, diag(D^{-1/2})), or None
        when the factors do not match."""
        from .dense import DenseLinearOperator

        d_factors = self.operators[1].operators
        k_factors = self._kron.operators
        if not self._whitening_shapes_match:
            return None
        whitened, d_invsqrt = [], []
        for kf, df in zip(k_factors, d_factors):
            inv_sqrt = torch.rsqrt(torch.clamp_min(df._diagonal(), 1e-30))
            d_invsqrt.append(inv_sqrt)
            kw = inv_sqrt[..., :, None] * kf.to_dense() * inv_sqrt[..., None, :]
            whitened.append(DenseLinearOperator((kw + kw.mT) / 2))
        evals, evecs = KroneckerProductLinearOperator(tuple(whitened)).eigh()
        return evals, evecs, _kron_vector(d_invsqrt)

    def _constant(self) -> torch.Tensor:
        return self.operators[1].diag[..., :1]  # (*b, 1)

    def _solve_structure(self, rhs: torch.Tensor):
        if self._is_constant_diag:
            evals, evecs = self._eigen()
            y = evecs._t_matmul(rhs) / (evals + self._constant())[..., :, None]
            return evecs._matmul(y)
        if self._is_kron_diag:
            w = self._whitened_eigen()
            if w is not None:
                evals, evecs, dinvs = w
                y = evecs._t_matmul(dinvs[..., :, None] * rhs) / (evals + 1.0)[..., :, None]
                return dinvs[..., :, None] * evecs._matmul(y)
        return None

    def _logdet_structure(self):
        if self._is_constant_diag:
            evals, _ = self._eigen()
            return torch.sum(torch.log(torch.clamp_min(evals + self._constant(), 1e-30)), dim=-1)
        if self._is_kron_diag:
            w = self._whitened_eigen()
            if w is not None:
                evals, _, dinvs = w
                return torch.sum(torch.log(torch.clamp_min(evals + 1.0, 1e-30)), dim=-1) - 2.0 * torch.sum(
                    torch.log(torch.clamp_min(dinvs, 1e-30)), dim=-1
                )
        return None

    def _inv_quad_logdet_structure(self, rhs, logdet: bool):
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        if self._is_kron_diag:
            if not self._whitening_shapes_match:
                # no whitened closed form: the generic CG path, which
                # with_preconditioner prepared for this case
                return None
            iq = zeros if rhs is None else torch.sum(self._solve_structure(rhs) * rhs, dim=-2)
            ld = self._logdet_structure().expand(self.batch_shape) if logdet else zeros
            return iq, ld
        if not self._is_constant_diag:
            return None
        evals, evecs = self._eigen()
        shifted = evals + self._constant()
        if rhs is None:
            iq = zeros
        else:
            y = evecs._t_matmul(rhs)
            iq = torch.sum(y * y / shifted[..., :, None], dim=-2)
        ld = torch.sum(torch.log(torch.clamp_min(shifted, 1e-30)), dim=-1).expand(self.batch_shape) if logdet else zeros
        return iq, ld

    def _root_structure(self):
        """(K + cI)^{1/2} = Q diag(sqrt(evals + c))."""
        if not self._is_constant_diag:
            return None
        from .matmul import MatmulLinearOperator

        evals, evecs = self._eigen()
        return MatmulLinearOperator(evecs, DiagLinearOperator(torch.sqrt(torch.clamp_min(evals + self._constant(), 0.0))))

    def _root_inv_structure(self):
        if not self._is_constant_diag:
            return None
        from .matmul import MatmulLinearOperator

        evals, evecs = self._eigen()
        inv_sqrt = torch.rsqrt(torch.clamp_min(evals + self._constant(), 1e-30))
        return MatmulLinearOperator(evecs, DiagLinearOperator(inv_sqrt))

    def __add__(self, other):
        if isinstance(other, DiagLinearOperator) and isinstance(self.operators[1], DiagLinearOperator):
            return KroneckerProductAddedDiagLinearOperator(self._kron, self.operators[1] + other)
        if isinstance(other, DiagLinearOperator):
            # a Kronecker diagonal plus a plain one has no closed form: a
            # generic AddedDiag, so that CG and its preconditioner apply
            return AddedDiagLinearOperator(self, other)
        return super().__add__(other)
