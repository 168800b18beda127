"""c * K with a scalar or batch-shaped constant (counterpart of
linear_operator_tpu/operators/constant_mul.py)."""

from __future__ import annotations

import torch

from ..utils.broadcasting import broadcast_shapes
from ._linear_operator import LinearOperator


class ConstantMulLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator, constant):
        self.base = base
        # scalar or batch-shaped
        self.constant = torch.as_tensor(constant, dtype=base.dtype, device=base.device)

    @property
    def _expanded_constant(self) -> torch.Tensor:
        c = self.constant
        return c.reshape(*c.shape, 1, 1) if c.ndim else c

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._expanded_constant * self.base._matmul(rhs)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._expanded_constant * self.base._t_matmul(rhs)

    def _matmul_closure(self):
        base_mm = self.base._matmul_closure()
        c = self._expanded_constant
        return lambda rhs: c * base_mm(rhs)

    def _shape(self) -> tuple[int, ...]:
        batch = broadcast_shapes(self.base.batch_shape, tuple(self.constant.shape))
        return (*batch, *self.base.matrix_shape)

    def _transpose(self) -> "ConstantMulLinearOperator":
        return ConstantMulLinearOperator(self.base._transpose(), self.constant)

    def _diagonal(self) -> torch.Tensor:
        c = self.constant
        return (c[..., None] if c.ndim else c) * self.base._diagonal()

    def to_dense(self) -> torch.Tensor:
        return self._expanded_constant * self.base.to_dense()

    def _solve_structure(self, rhs: torch.Tensor):
        return self.base._solve_structure(rhs / self._expanded_constant)

    def _logdet_structure(self):
        ld = self.base._logdet_structure()
        if ld is None:
            return None
        return ld + self.shape[-1] * torch.log(self.constant.expand(self.batch_shape))

    def _root_structure(self):
        root = self.base.root_decomposition().root
        return ConstantMulLinearOperator(root, torch.sqrt(self.constant))

    def mul(self, other):
        if not isinstance(other, LinearOperator):
            other = torch.as_tensor(other, dtype=self.dtype, device=self.device)
            if other.ndim == 0 or other.ndim <= self.ndim - 2:
                return ConstantMulLinearOperator(self.base, self.constant * other)
        return super().mul(other)

    def _expand_batch(self, batch_shape) -> "ConstantMulLinearOperator":
        c = self.constant.expand(batch_shape) if self.constant.ndim else self.constant
        return ConstantMulLinearOperator(self.base._expand_batch(batch_shape), c)

    def _indexed_constant(self, batch_indices) -> torch.Tensor:
        """The constant broadcast to the operator's batch shape before batch
        indexing (it may carry fewer or singleton batch dims)."""
        c = self.constant
        if c.ndim and batch_indices:
            c = c.expand(self.batch_shape)[tuple(batch_indices)]
        return c

    def _getitem(self, row_index, col_index, *batch_indices) -> "ConstantMulLinearOperator":
        base = self.base._expanded_to(self.batch_shape)
        return ConstantMulLinearOperator(
            base._getitem(row_index, col_index, *batch_indices), self._indexed_constant(batch_indices)
        )

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """c K[*batch_indices, row_index, col_index], the base broadcast to
        the operator's batch before batch indexing (the constant and the base
        may each carry fewer or singleton batch dims)."""
        base = self.base._expanded_to(self.batch_shape)
        return self._indexed_constant(batch_indices) * base._get_indices(row_index, col_index, *batch_indices)
