"""Triangular operator with direct triangular solves (counterpart of
linear_operator_tpu/operators/triangular.py, as far as the Cholesky paths of
``solve`` and ``inv_quad_logdet`` and the root decompositions need it)."""

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

    def _cholesky_impl(self, upper: bool = False):
        raise NotPSDError("TriangularLinearOperator is not PSD")

    def _root_structure(self):
        raise NotPSDError("root decomposition of a triangular operator")

    def _expand_batch(self, batch_shape) -> "TriangularLinearOperator":
        if isinstance(self.tensor, LinearOperator):
            return TriangularLinearOperator(self.tensor._expand_batch(batch_shape), upper=self.upper)
        return TriangularLinearOperator(self.tensor.expand(*batch_shape, *self.matrix_shape), upper=self.upper)

    def inverse(self) -> "TriangularLinearOperator":
        """L^{-1} by a triangular solve against the identity."""
        n = self.shape[-1]
        eye = torch.eye(n, dtype=self.dtype, device=self.device).expand(*self.batch_shape, n, n)
        return TriangularLinearOperator(self._solve_structure(eye), upper=self.upper)
