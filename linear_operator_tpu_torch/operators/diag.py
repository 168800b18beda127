"""Diagonal operators: O(N) everything (counterpart of
linear_operator_tpu/operators/diag.py)."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class DiagLinearOperator(LinearOperator):
    def __init__(self, diag: torch.Tensor):
        self.diag = diag  # (*b, n)

    @property
    def _inherently_triangular(self) -> bool:
        return True

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.diag[..., :, None] * rhs

    def _shape(self) -> tuple[int, ...]:
        return (*self.diag.shape, self.diag.shape[-1])

    def _transpose(self) -> "DiagLinearOperator":
        return self

    def _diagonal(self) -> torch.Tensor:
        return self.diag

    def to_dense(self) -> torch.Tensor:
        return torch.diag_embed(self._diagonal())

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        return rhs / self.diag[..., :, None]

    def _logdet_structure(self) -> torch.Tensor:
        return torch.sum(torch.log(self._diagonal()), dim=-1)

    def _inv_quad_logdet_structure(self, rhs, logdet):
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        iq = zeros if rhs is None else torch.sum(rhs * rhs / self.diag[..., :, None], dim=-2)
        return iq, self._logdet_structure() if logdet else zeros

    def _cholesky_impl(self, upper: bool = False) -> LinearOperator:
        from .triangular import TriangularLinearOperator

        return TriangularLinearOperator(torch.diag_embed(self._diagonal().sqrt()), upper=upper)

    def _root_structure(self) -> "DiagLinearOperator":
        return DiagLinearOperator(torch.sqrt(self.diag))

    def _root_inv_structure(self) -> "DiagLinearOperator":
        return DiagLinearOperator(torch.rsqrt(self.diag))

    def inverse(self) -> "DiagLinearOperator":
        return DiagLinearOperator(1.0 / self.diag)

    def _expand_batch(self, batch_shape) -> "DiagLinearOperator":
        return DiagLinearOperator(self.diag.expand(*batch_shape, self.diag.shape[-1]))

    def __add__(self, other):
        if isinstance(other, DiagLinearOperator):
            return DiagLinearOperator(self._diagonal() + other._diagonal())
        if isinstance(other, LinearOperator):
            return other.add_diagonal(self._diagonal())
        return super().__add__(other)


class ConstantDiagLinearOperator(DiagLinearOperator):
    """c * I with batched constants; ``diag`` holds the constant with a
    trailing singleton, (*b, 1)."""

    def __init__(self, diag: torch.Tensor, diag_shape: int = 1):
        super().__init__(diag)
        self.diag_shape = diag_shape

    def _shape(self) -> tuple[int, ...]:
        return (*self.diag.shape[:-1], self.diag_shape, self.diag_shape)

    def _diagonal(self) -> torch.Tensor:
        return self.diag.expand(*self.diag.shape[:-1], self.diag_shape)

    def _logdet_structure(self) -> torch.Tensor:
        return self.diag_shape * torch.log(self.diag[..., 0])

    def _root_structure(self) -> "ConstantDiagLinearOperator":
        return ConstantDiagLinearOperator(torch.sqrt(self.diag), diag_shape=self.diag_shape)

    def _root_inv_structure(self) -> "ConstantDiagLinearOperator":
        return ConstantDiagLinearOperator(torch.rsqrt(self.diag), diag_shape=self.diag_shape)

    def inverse(self) -> "ConstantDiagLinearOperator":
        return ConstantDiagLinearOperator(1.0 / self.diag, diag_shape=self.diag_shape)

    def _expand_batch(self, batch_shape) -> "ConstantDiagLinearOperator":
        return ConstantDiagLinearOperator(self.diag.expand(*batch_shape, 1), diag_shape=self.diag_shape)

    def __add__(self, other):
        if isinstance(other, ConstantDiagLinearOperator):
            return ConstantDiagLinearOperator(self.diag + other.diag, diag_shape=self.diag_shape)
        return super().__add__(other)


def diag_operator(diag, op: LinearOperator) -> DiagLinearOperator:
    """The diagonal operator that ``add_diagonal`` adds to the square ``op``:
    a scalar or trailing-singleton ``diag`` becomes a
    ConstantDiagLinearOperator, anything else a DiagLinearOperator."""
    diag = torch.as_tensor(diag, dtype=op.dtype, device=op.device)
    n = op.shape[-1]
    if diag.ndim == 0:
        return ConstantDiagLinearOperator(diag[None], diag_shape=n)
    if diag.shape[-1] == 1:
        return ConstantDiagLinearOperator(diag, diag_shape=n)
    return DiagLinearOperator(diag.expand(*diag.shape[:-1], n))
