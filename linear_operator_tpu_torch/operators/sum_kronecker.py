"""Sum of two Kronecker products: A (x) B + C (x) D (counterpart of
linear_operator_tpu/operators/sum_kronecker.py).

Solves and log-determinants whiten by the right-hand product: with
S = C^{-1/2} A C^{-T/2} (x) D^{-1/2} B D^{-T/2} = Q L Q^T (a Kronecker
eigendecomposition) and W = C^{1/2} (x) D^{1/2},

    (A(x)B + C(x)D)^{-1} = W^{-T} Q (L + I)^{-1} Q^T W^{-1}
    log det = sum log(L_kron + 1) + log det(C (x) D)

Every application is a Kronecker sweep; only the O(N) eigenvalue vector is
formed.
"""

from __future__ import annotations

import torch

from .dense import DenseLinearOperator
from .kronecker import KroneckerProductLinearOperator, _kron_vector
from .sum import SumLinearOperator


def _inv_root(f) -> torch.Tensor:
    from ..functions import root_inv_decomposition

    r = f._root_inv_structure()
    return (root_inv_decomposition(f).root if r is None else r).to_dense()


class SumKroneckerLinearOperator(SumLinearOperator):
    """operators = (KP(A, B), KP(C, D)), both two-factor products."""

    def __init__(self, operators: tuple):
        super().__init__(operators)
        if len(self.operators) != 2 or not all(
            isinstance(o, KroneckerProductLinearOperator) and len(o.operators) == 2 for o in self.operators
        ):
            raise ValueError("SumKroneckerLinearOperator takes two 2-factor Kronecker products")

    def _whitened(self):
        kp1, kp2 = self.operators
        A, B = kp1.operators
        C, D = kp2.operators
        cir, dir_ = _inv_root(C), _inv_root(D)
        a_w = cir.mT @ A.to_dense() @ cir
        b_w = dir_.mT @ B.to_dense() @ dir_
        la, qa = torch.linalg.eigh((a_w + a_w.mT) / 2)
        lb, qb = torch.linalg.eigh((b_w + b_w.mT) / 2)
        evals = _kron_vector([la, lb])  # (*b, N)
        q_kron = KroneckerProductLinearOperator((DenseLinearOperator(qa), DenseLinearOperator(qb)))
        # K^{-1} of each right-hand factor is its inverse root times its transpose
        w_inv = KroneckerProductLinearOperator((DenseLinearOperator(cir), DenseLinearOperator(dir_)))
        return evals, q_kron, w_inv, C, D

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        evals, q, w_inv, _, _ = self._whitened()
        y = q._t_matmul(w_inv._t_matmul(rhs)) / (evals + 1.0)[..., :, None]
        return w_inv._matmul(q._matmul(y))

    def _logdet_structure(self) -> torch.Tensor:
        from ..functions import inv_quad_logdet

        evals, _, _, C, D = self._whitened()
        _, ld_c = inv_quad_logdet(C, None, logdet=True)
        _, ld_d = inv_quad_logdet(D, None, logdet=True)
        return (
            torch.sum(torch.log(torch.clamp_min(evals + 1.0, 1e-30)), dim=-1)
            + D.shape[-1] * ld_c
            + C.shape[-1] * ld_d
        )

    def _inv_quad_logdet_structure(self, rhs, logdet: bool):
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        iq = zeros if rhs is None else torch.sum(self._solve_structure(rhs) * rhs, dim=-2)
        ld = self._logdet_structure().expand(self.batch_shape) if logdet else zeros
        return iq, ld

    def _root_structure(self):
        """(A(x)B + C(x)D)^{1/2} = W Q (L + I)^{1/2}."""
        from ..functions import root_decomposition
        from .diag import DiagLinearOperator
        from .matmul import MatmulLinearOperator

        evals, q, _, C, D = self._whitened()
        c_r = C._root_structure()
        d_r = D._root_structure()
        if c_r is None or d_r is None:
            c_r = c_r or root_decomposition(C).root
            d_r = d_r or root_decomposition(D).root
        w = KroneckerProductLinearOperator((c_r, d_r))
        sqrt_l = DiagLinearOperator(torch.sqrt(torch.clamp_min(evals + 1.0, 0.0)))
        return MatmulLinearOperator(MatmulLinearOperator(w, q), sqrt_l)
