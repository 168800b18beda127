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

    def exp(self) -> "DiagLinearOperator":
        return DiagLinearOperator(torch.exp(self._diagonal()))

    def log(self) -> "DiagLinearOperator":
        return DiagLinearOperator(torch.log(self._diagonal()))

    def abs(self) -> "DiagLinearOperator":
        return DiagLinearOperator(torch.abs(self._diagonal()))

    def sqrt(self) -> "DiagLinearOperator":
        return DiagLinearOperator(torch.sqrt(self._diagonal()))

    def solve_triangular(self, rhs: torch.Tensor, *, upper: bool, left: bool = True, unitriangular: bool = False):
        """A diagonal is both upper and lower triangular, so ``upper`` does
        not matter; with ``unitriangular`` the diagonal must be ones."""
        if unitriangular:
            if not bool(torch.all(self._diagonal() == 1)):
                raise RuntimeError("Received `unitriangular=True` but `LinearOperator` does not have a unit diagonal.")
            return rhs
        d = self._diagonal()
        if rhs.ndim == 1:
            return rhs / d
        return rhs / (d[..., :, None] if left else d[..., None, :])

    def matmul(self, other):
        from .dense import DenseLinearOperator
        from .triangular import TriangularLinearOperator

        if isinstance(other, DiagLinearOperator):
            return DiagLinearOperator(self._diagonal() * other._diagonal())
        if isinstance(other, DenseLinearOperator):
            return DenseLinearOperator(self._diagonal()[..., :, None] * other.tensor)
        if isinstance(other, TriangularLinearOperator):
            inner = other.tensor if isinstance(other.tensor, LinearOperator) else DenseLinearOperator(other.tensor)
            return TriangularLinearOperator(self.matmul(inner), upper=other.upper)
        from .block import BlockDiagLinearOperator

        if isinstance(other, BlockDiagLinearOperator) and type(other) is BlockDiagLinearOperator:
            # D blockdiag(B_1, ..., B_k) = blockdiag(D_1 B_1, ..., D_k B_k)
            diag = self._diagonal().reshape(*other.base.shape[:-1])
            return BlockDiagLinearOperator(DiagLinearOperator(diag).matmul(other.base))
        return super().matmul(other)

    def mul(self, other):
        if isinstance(other, DiagLinearOperator):
            return DiagLinearOperator(self._diagonal() * other._diagonal())
        return super().mul(other)

    def _expand_batch(self, batch_shape) -> "DiagLinearOperator":
        return DiagLinearOperator(self.diag.expand(*batch_shape, self.diag.shape[-1]))

    def _unsqueeze_batch(self, dim: int) -> "DiagLinearOperator":
        return self._replace(diag=self.diag.unsqueeze(dim))

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        if isinstance(row_index, slice) and isinstance(col_index, slice) and row_index == col_index:
            return DiagLinearOperator(self._diagonal()[(*batch_indices, row_index)])
        return super()._getitem(row_index, col_index, *batch_indices)

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        vals = self._diagonal()[(*batch_indices, row_index)]
        return torch.where(row_index == col_index, vals, torch.zeros_like(vals))

    def zero_mean_mvn_samples(self, num_samples: int, *, generator: torch.Generator | None = None) -> torch.Tensor:
        from ..utils.random import randn

        base = randn((num_samples, *self.batch_shape, self.shape[-1]), self.dtype, self.device, generator)
        return base * torch.sqrt(self._diagonal())

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

    def _map_constant(self, fn) -> "ConstantDiagLinearOperator":
        return ConstantDiagLinearOperator(fn(self.diag), diag_shape=self.diag_shape)

    # the JAX package's ConstantDiag inherits Diag's exp, log, abs and matmul,
    # which apply to its (*b, 1) constant and return a 1 x 1 operator
    def sqrt(self) -> "ConstantDiagLinearOperator":
        return self._map_constant(torch.sqrt)

    def exp(self) -> "ConstantDiagLinearOperator":
        return self._map_constant(torch.exp)

    def log(self) -> "ConstantDiagLinearOperator":
        return self._map_constant(torch.log)

    def abs(self) -> "ConstantDiagLinearOperator":
        return self._map_constant(torch.abs)

    def matmul(self, other):
        if isinstance(other, ConstantDiagLinearOperator):
            return ConstantDiagLinearOperator(self.diag * other.diag, diag_shape=self.diag_shape)
        return super().matmul(other)

    def _expand_batch(self, batch_shape) -> "ConstantDiagLinearOperator":
        return ConstantDiagLinearOperator(self.diag.expand(*batch_shape, 1), diag_shape=self.diag_shape)

    def _getitem(self, row_index, col_index, *batch_indices):
        if isinstance(row_index, slice) and isinstance(col_index, slice) and row_index == col_index:
            new_n = len(range(*row_index.indices(self.diag_shape)))
            return ConstantDiagLinearOperator(self.diag[(*batch_indices, slice(None))], diag_shape=new_n)
        return super()._getitem(row_index, col_index, *batch_indices)

    def __add__(self, other):
        if isinstance(other, ConstantDiagLinearOperator):
            return ConstantDiagLinearOperator(self.diag + other.diag, diag_shape=self.diag_shape)
        return super().__add__(other)

    def mul(self, other):
        if isinstance(other, ConstantDiagLinearOperator):
            return ConstantDiagLinearOperator(self.diag * other.diag, diag_shape=self.diag_shape)
        return super().mul(other)


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
