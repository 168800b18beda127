"""Triangular operator with direct triangular solves (counterpart of
linear_operator_tpu/operators/triangular.py)."""

from __future__ import annotations

import torch

from ..utils.errors import NotPSDError
from ._linear_operator import LinearOperator


class TriangularLinearOperator(LinearOperator):
    def __init__(self, tensor, upper: bool = False):
        # (*b, n, n): a tensor whose dead triangle is ignored, or an operator
        # (an inherently triangular one, a Kronecker product of triangular
        # factors, keeps its structured products and solves)
        self.tensor = tensor
        self.upper = upper

    @property
    def _structured(self) -> bool:
        return isinstance(self.tensor, LinearOperator) and self.tensor._inherently_triangular

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        if self._structured:
            return self.tensor._matmul(rhs)
        return torch.matmul(self.to_dense(), rhs)

    def _shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    def _transpose(self) -> "TriangularLinearOperator":
        return TriangularLinearOperator(self.tensor.mT, upper=not self.upper)

    def _diagonal(self) -> torch.Tensor:
        if isinstance(self.tensor, LinearOperator):
            return self.tensor._diagonal()
        return torch.diagonal(self.tensor, dim1=-2, dim2=-1)

    def to_dense(self) -> torch.Tensor:
        dense = self.tensor.to_dense() if isinstance(self.tensor, LinearOperator) else self.tensor
        return torch.triu(dense) if self.upper else torch.tril(dense)

    def _broadcast(self, rhs: torch.Tensor):
        batch = torch.broadcast_shapes(self.batch_shape, rhs.shape[:-2])
        return (
            self.to_dense().expand(*batch, *self.matrix_shape),
            rhs.expand(*batch, *rhs.shape[-2:]),
        )

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        if self._structured:
            inner = self.tensor._solve_structure(rhs)
            if inner is not None:
                return inner
        dense, rhs = self._broadcast(rhs)
        return torch.linalg.solve_triangular(dense, rhs, upper=self.upper)

    def _cholesky_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve (R R^T) x = rhs with R = self, by two triangular solves."""
        dense, rhs = self._broadcast(rhs)
        y = torch.linalg.solve_triangular(dense, rhs, upper=self.upper)
        return torch.linalg.solve_triangular(dense.mT, y, upper=not self.upper)

    def solve_triangular(self, rhs: torch.Tensor, *, upper: bool, left: bool = True, unitriangular: bool = False):
        """``upper`` must be the operator's own orientation."""
        if upper != self.upper:
            raise RuntimeError(
                f"solve_triangular called with upper={upper}, but the operator is "
                f"{'upper' if self.upper else 'lower'} triangular"
            )
        if unitriangular:
            raise NotImplementedError("unitriangular=True is not supported")
        if not left:
            return self._transpose()._solve_structure(rhs.mT).mT
        return self._solve_structure(rhs)

    def _logdet_structure(self) -> torch.Tensor:
        """log |det| = sum log |diag|."""
        return torch.sum(torch.log(torch.abs(self._diagonal())), dim=-1)

    def _inv_quad_logdet_structure(self, rhs, logdet):
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        iq = zeros if rhs is None else torch.sum(self._solve_structure(rhs) * rhs, dim=-2)
        return iq, self._logdet_structure() if logdet else zeros

    def _cholesky_impl(self, upper: bool = False):
        raise NotPSDError("TriangularLinearOperator is not PSD")

    def _root_structure(self):
        raise NotPSDError("root decomposition of a triangular operator")

    def _expand_batch(self, batch_shape) -> "TriangularLinearOperator":
        if isinstance(self.tensor, LinearOperator):
            return TriangularLinearOperator(self.tensor._expand_batch(batch_shape), upper=self.upper)
        return TriangularLinearOperator(self.tensor.expand(*batch_shape, *self.matrix_shape), upper=self.upper)

    def _inner_op(self) -> LinearOperator:
        from .dense import DenseLinearOperator

        return self.tensor if isinstance(self.tensor, LinearOperator) else DenseLinearOperator(self.tensor)

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        if (
            isinstance(row_index, slice)
            and isinstance(col_index, slice)
            and row_index == col_index
            # a negative step reverses rows and columns and flips the triangle
            and (row_index.step is None or row_index.step > 0)
        ):
            # a principal submatrix of a triangular matrix is triangular
            inner = self._inner_op()._getitem(row_index, col_index, *batch_indices)
            return TriangularLinearOperator(inner, upper=self.upper)
        # other slices lose the structure: mask, then slice
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense()[(*batch_indices, row_index, col_index)])

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        vals = self._inner_op()._get_indices(row_index, col_index, *batch_indices)
        keep = (row_index <= col_index) if self.upper else (row_index >= col_index)
        return torch.where(keep, vals, torch.zeros_like(vals))

    def __add__(self, other):
        if isinstance(other, TriangularLinearOperator) and other.upper == self.upper:
            return TriangularLinearOperator(self.to_dense() + other.to_dense(), upper=self.upper)
        return super().__add__(other)

    def inverse(self) -> "TriangularLinearOperator":
        """L^{-1} by a triangular solve against the identity."""
        n = self.shape[-1]
        eye = torch.eye(n, dtype=self.dtype, device=self.device).expand(*self.batch_shape, n, n)
        return TriangularLinearOperator(self._solve_structure(eye), upper=self.upper)
