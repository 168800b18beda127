"""Permutation operators, P x = x[perm] (counterpart of
linear_operator_tpu/operators/permutation.py): the mat-vec is a gather, the
solve the transposed gather, the log-determinant 0."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class PermutationLinearOperator(LinearOperator):
    def __init__(self, perm: torch.Tensor, dtype: torch.dtype | None = None):
        self.perm = perm  # (*b, n) int: row i selects source index perm[i]
        self.dtype_ = dtype

    @property
    def dtype(self) -> torch.dtype:
        # float32 unless cast: the matrix is real 0/1, its one tensor integer
        return self.dtype_ if self.dtype_ is not None else torch.float32

    def astype(self, dtype) -> "PermutationLinearOperator":
        return self._replace(dtype_=dtype)

    def _shape(self) -> tuple[int, ...]:
        return (*self.perm.shape, self.perm.shape[-1])

    def _inv_perm(self) -> torch.Tensor:
        return torch.argsort(self.perm, dim=-1)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        batch = torch.broadcast_shapes(self.perm.shape[:-1], rhs.shape[:-2])
        rhs_b = rhs.expand(*batch, *rhs.shape[-2:])
        idx = self.perm[..., :, None].expand(*batch, self.perm.shape[-1], rhs.shape[-1])
        return torch.gather(rhs_b, -2, idx)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._transpose()._matmul(rhs)

    def _transpose(self) -> "PermutationLinearOperator":
        return PermutationLinearOperator(self._inv_perm(), dtype=self.dtype_)

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._t_matmul(rhs)

    def _logdet_structure(self) -> torch.Tensor:
        return torch.zeros(self.perm.shape[:-1], dtype=self.dtype, device=self.perm.device)

    def _diagonal(self) -> torch.Tensor:
        n = self.perm.shape[-1]
        return (self.perm == torch.arange(n, device=self.perm.device)).to(self.dtype)

    def to_dense(self) -> torch.Tensor:
        n = self.perm.shape[-1]
        return torch.nn.functional.one_hot(self.perm, n).to(self.dtype)

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        sel = self.perm[(*batch_indices, row_index)]
        return (sel == col_index).to(self.dtype)

    def inverse(self) -> "PermutationLinearOperator":
        return self._transpose()


class TransposePermutationLinearOperator(PermutationLinearOperator):
    """The vec-transpose permutation, vec(A) -> vec(A^T) for m x m A."""

    @staticmethod
    def from_side(m: int, device=None) -> "TransposePermutationLinearOperator":
        i = torch.arange(m * m, device=device)
        return TransposePermutationLinearOperator((i % m) * m + i // m)

    def _transpose(self) -> "TransposePermutationLinearOperator":
        return self  # a symmetric involution

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._matmul(rhs)
