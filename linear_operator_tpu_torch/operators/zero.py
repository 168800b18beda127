"""Zero operator, the null element of the operator algebra (counterpart of
linear_operator_tpu/operators/zero.py).  It holds no tensor, so it carries
its dtype and device itself."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class ZeroLinearOperator(LinearOperator):
    def __init__(self, shape: tuple, dtype=torch.float32, device=None):
        self.shape_ = tuple(shape)
        self.dtype_ = dtype
        self.device_ = torch.device(device) if device is not None else torch.device("cpu")

    @property
    def dtype(self) -> torch.dtype:
        return self.dtype_

    @property
    def device(self) -> torch.device:
        return self.device_

    @property
    def _inherently_triangular(self) -> bool:
        return True

    def _like(self, shape) -> "ZeroLinearOperator":
        return ZeroLinearOperator(shape, dtype=self.dtype_, device=self.device_)

    def astype(self, dtype) -> "ZeroLinearOperator":
        return ZeroLinearOperator(self.shape_, dtype=dtype, device=self.device_)

    def to(self, *args, **kwargs) -> "ZeroLinearOperator":
        out = self
        for a in (*args, *kwargs.values()):
            if isinstance(a, torch.dtype):
                out = out.astype(a)
            else:
                out = ZeroLinearOperator(out.shape_, dtype=out.dtype_, device=a)
        return out

    def _shape(self) -> tuple[int, ...]:
        return self.shape_

    def _zeros(self, rows: int, rhs: torch.Tensor) -> torch.Tensor:
        batch = torch.broadcast_shapes(self.shape_[:-2], rhs.shape[:-2])
        dtype = torch.promote_types(self.dtype_, rhs.dtype)
        return torch.zeros((*batch, rows, rhs.shape[-1]), dtype=dtype, device=rhs.device)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._zeros(self.shape_[-2], rhs)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._zeros(self.shape_[-1], rhs)

    def _transpose(self) -> "ZeroLinearOperator":
        return self._like((*self.shape_[:-2], self.shape_[-1], self.shape_[-2]))

    def _diagonal(self) -> torch.Tensor:
        return torch.zeros((*self.shape_[:-2], min(self.shape_[-2:])), dtype=self.dtype_, device=self.device_)

    def to_dense(self) -> torch.Tensor:
        return torch.zeros(self.shape_, dtype=self.dtype_, device=self.device_)

    def _solve_structure(self, rhs):
        raise RuntimeError("ZeroLinearOperator is singular; solve is undefined")

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            # 0 + A = A, broadcast to this operator's batch shape
            target = torch.broadcast_shapes(self.batch_shape, other.batch_shape)
            return other._expand_batch(tuple(target)) if tuple(target) != tuple(other.batch_shape) else other
        from .dense import DenseLinearOperator

        other = torch.as_tensor(other, dtype=self.dtype_, device=self.device_)
        return DenseLinearOperator(other.expand(self.shape_))

    def mul(self, other):
        return self

    def matmul(self, other):
        if isinstance(other, LinearOperator):
            return self._like((*self.shape_[:-1], other.shape[-1]))
        return super().matmul(other)

    def _expand_batch(self, batch_shape) -> "ZeroLinearOperator":
        return self._like((*batch_shape, *self.shape_[-2:]))

    def _getitem(self, row_index, col_index, *batch_indices):
        from ..utils.getitem import sliced_shape

        return self._like(sliced_shape(self.shape_, *batch_indices, row_index, col_index))

