"""Dense operator wrapping a plain tensor (counterpart of
linear_operator_tpu/operators/dense.py)."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class DenseLinearOperator(LinearOperator):
    def __init__(self, tensor: torch.Tensor):
        if tensor.ndim < 2:
            raise ValueError("DenseLinearOperator requires ndim >= 2")
        self.tensor = tensor  # (*b, m, n)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.tensor, rhs)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.tensor.mT, rhs)

    def _shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    def _transpose(self) -> "DenseLinearOperator":
        return DenseLinearOperator(self.tensor.mT)

    def _diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.tensor, dim1=-2, dim2=-1)

    def to_dense(self) -> torch.Tensor:
        return self.tensor

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        return self.tensor[(*batch_indices, row_index, col_index)]

    def _select_cols(self, idx) -> "DenseLinearOperator":
        return DenseLinearOperator(self.tensor[..., :, idx])
