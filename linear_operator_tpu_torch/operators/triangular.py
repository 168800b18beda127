"""Triangular operator with direct triangular solves (counterpart of
linear_operator_tpu/operators/triangular.py, as far as the Cholesky paths of
``solve`` and ``inv_quad_logdet`` need it)."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class TriangularLinearOperator(LinearOperator):
    def __init__(self, tensor: torch.Tensor, upper: bool = False):
        self.tensor = tensor  # (*b, n, n), the dead triangle is ignored
        self.upper = upper

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.to_dense(), rhs)

    def _shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    def _transpose(self) -> "TriangularLinearOperator":
        return TriangularLinearOperator(self.tensor.mT, upper=not self.upper)

    def _diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.tensor, dim1=-2, dim2=-1)

    def to_dense(self) -> torch.Tensor:
        return torch.triu(self.tensor) if self.upper else torch.tril(self.tensor)

    def _broadcast(self, rhs: torch.Tensor):
        batch = torch.broadcast_shapes(self.tensor.shape[:-2], rhs.shape[:-2])
        return (
            self.to_dense().expand(*batch, *self.tensor.shape[-2:]),
            rhs.expand(*batch, *rhs.shape[-2:]),
        )

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        dense, rhs = self._broadcast(rhs)
        return torch.linalg.solve_triangular(dense, rhs, upper=self.upper)

    def _cholesky_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve (R R^T) x = rhs with R = self, by two triangular solves."""
        dense, rhs = self._broadcast(rhs)
        y = torch.linalg.solve_triangular(dense, rhs, upper=self.upper)
        return torch.linalg.solve_triangular(dense.mT, y, upper=not self.upper)
