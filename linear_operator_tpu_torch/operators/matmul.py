"""Lazy product A @ B (counterpart of linear_operator_tpu/operators/matmul.py)."""

from __future__ import annotations

import torch

from ..utils.broadcasting import matmul_broadcast_shape
from ._linear_operator import LinearOperator, to_linear_operator


class MatmulLinearOperator(LinearOperator):
    def __init__(self, left, right):
        self.left = to_linear_operator(left)
        self.right = to_linear_operator(right)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.left._matmul(self.right._matmul(rhs))

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.right._t_matmul(self.left._t_matmul(rhs))

    def _shape(self) -> tuple[int, ...]:
        return matmul_broadcast_shape(self.left.shape, self.right.shape)

    def _transpose(self) -> "MatmulLinearOperator":
        return MatmulLinearOperator(self.right._transpose(), self.left._transpose())

    def _diagonal(self) -> torch.Tensor:
        # diag(A B) = sum(A * B^T, -1)
        return torch.einsum("...ij,...ji->...i", self.left.to_dense(), self.right.to_dense())

    def to_dense(self) -> torch.Tensor:
        # diagonal factors scale rows or columns instead of a dense product
        from .diag import DiagLinearOperator

        left, right = self.left, self.right
        if isinstance(left, DiagLinearOperator) and not isinstance(right, DiagLinearOperator):
            return left._diagonal()[..., :, None] * right.to_dense()
        if isinstance(right, DiagLinearOperator):
            return left.to_dense() * right._diagonal()[..., None, :]
        return torch.matmul(left.to_dense(), right.to_dense())

    def _expand_batch(self, batch_shape) -> "MatmulLinearOperator":
        return MatmulLinearOperator(self.left._expand_batch(batch_shape), self.right._expand_batch(batch_shape))

    def _getitem(self, row_index, col_index, *batch_indices) -> "MatmulLinearOperator":
        left, right = self.left, self.right
        if batch_indices:
            left = left._expanded_to(self.batch_shape)
            right = right._expanded_to(self.batch_shape)
        return MatmulLinearOperator(
            left._getitem(row_index, slice(None), *batch_indices),
            right._getitem(slice(None), col_index, *batch_indices),
        )
