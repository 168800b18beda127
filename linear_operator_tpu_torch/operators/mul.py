"""Elementwise (Hadamard) product of two PSD operators through their roots
(counterpart of linear_operator_tpu/operators/mul.py).  With A = L_A L_A^T
and B = L_B L_B^T, A o B = R R^T with R[i, (k, l)] = L_A[i, k] L_B[i, l]
(the row-wise Khatri-Rao product).  The mat-vec never forms R: for each rhs
column v, M = L_A^T diag(v) L_B and (A o B) v = sum_l (L_A M)[:, l] L_B[:, l],
two einsums."""

from __future__ import annotations

import torch

from ..utils.broadcasting import broadcast_shapes
from ._linear_operator import LinearOperator


class MulLinearOperator(LinearOperator):
    def __init__(self, left_root: LinearOperator, right_root: LinearOperator):
        self.left_root = left_root  # (*b, n, rA)
        self.right_root = right_root  # (*b, n, rB)

    @staticmethod
    def from_operators(left: LinearOperator, right: LinearOperator) -> "MulLinearOperator":
        from .root import RootLinearOperator

        lr = left.root if isinstance(left, RootLinearOperator) else left.root_decomposition().root
        rr = right.root if isinstance(right, RootLinearOperator) else right.root_decomposition().root
        return MulLinearOperator(lr, rr)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        la = self.left_root.to_dense()
        lb = self.right_root.to_dense()
        m = torch.einsum("...nk,...nt,...nl->...tkl", la, rhs, lb)
        return torch.einsum("...nk,...tkl,...nl->...nt", la, m, lb)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._matmul(rhs)

    def _shape(self) -> tuple[int, ...]:
        batch = broadcast_shapes(self.left_root.batch_shape, self.right_root.batch_shape)
        n = self.left_root.shape[-2]
        return (*batch, n, n)

    def _transpose(self) -> "MulLinearOperator":
        return self

    def _diagonal(self) -> torch.Tensor:
        la = self.left_root.to_dense()
        lb = self.right_root.to_dense()
        return torch.sum(la * la, dim=-1) * torch.sum(lb * lb, dim=-1)

    def to_dense(self) -> torch.Tensor:
        la = self.left_root.to_dense()
        lb = self.right_root.to_dense()
        return (la @ la.mT) * (lb @ lb.mT)

    def _root_structure(self) -> LinearOperator:
        from .dense import DenseLinearOperator

        la = self.left_root.to_dense()
        lb = self.right_root.to_dense()
        batch = torch.broadcast_shapes(la.shape[:-2], lb.shape[:-2])
        r = la[..., :, :, None] * lb[..., :, None, :]
        return DenseLinearOperator(r.reshape(*batch, la.shape[-2], la.shape[-1] * lb.shape[-1]))

    def _expand_batch(self, batch_shape) -> "MulLinearOperator":
        return MulLinearOperator(self.left_root._expand_batch(batch_shape), self.right_root._expand_batch(batch_shape))
