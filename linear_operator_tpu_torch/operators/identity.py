"""Identity operator: no-op products and solves (counterpart of
linear_operator_tpu/operators/identity.py).  It holds no tensor, so it
carries its dtype and device itself."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator


class IdentityLinearOperator(LinearOperator):
    def __init__(self, diag_shape: int, batch_shape: tuple = (), dtype=torch.float32, device=None):
        self.diag_shape = diag_shape
        self.batch_shape_ = tuple(batch_shape)
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

    def _like(self, **fields) -> "IdentityLinearOperator":
        kw = dict(diag_shape=self.diag_shape, batch_shape=self.batch_shape_, dtype=self.dtype_, device=self.device_)
        kw.update(fields)
        return IdentityLinearOperator(**kw)

    def astype(self, dtype) -> "IdentityLinearOperator":
        return self._like(dtype=dtype)

    def to(self, *args, **kwargs) -> "IdentityLinearOperator":
        out = self
        for a in (*args, *kwargs.values()):
            out = out._like(dtype=a) if isinstance(a, torch.dtype) else out._like(device=a)
        return out

    def _constant(self, value) -> ConstantDiagLinearOperator:
        c = torch.full((*self.batch_shape_, 1), value, dtype=self.dtype_, device=self.device_)
        return ConstantDiagLinearOperator(c, diag_shape=self.diag_shape)

    def _shape(self) -> tuple[int, ...]:
        return (*self.batch_shape_, self.diag_shape, self.diag_shape)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        batch = torch.broadcast_shapes(self.batch_shape_, rhs.shape[:-2])
        return rhs.expand(*batch, *rhs.shape[-2:])

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._matmul(rhs)

    def _transpose(self) -> "IdentityLinearOperator":
        return self

    def _diagonal(self) -> torch.Tensor:
        return torch.ones((*self.batch_shape_, self.diag_shape), dtype=self.dtype_, device=self.device_)

    def to_dense(self) -> torch.Tensor:
        eye = torch.eye(self.diag_shape, dtype=self.dtype_, device=self.device_)
        return eye.expand(*self.batch_shape_, self.diag_shape, self.diag_shape)

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._matmul(rhs)

    def _logdet_structure(self) -> torch.Tensor:
        return torch.zeros(self.batch_shape_, dtype=self.dtype_, device=self.device_)

    def _inv_quad_logdet_structure(self, rhs, logdet):
        if rhs is None:
            iq = torch.zeros(self.batch_shape_, dtype=self.dtype_, device=self.device_)
        else:
            iq = torch.sum(rhs * rhs, dim=-2)
        return iq, self._logdet_structure()

    def _cholesky_impl(self, upper: bool = False):
        from .triangular import TriangularLinearOperator

        return TriangularLinearOperator(self, upper=upper)

    def _root_structure(self) -> "IdentityLinearOperator":
        return self

    def _root_inv_structure(self) -> "IdentityLinearOperator":
        return self

    def inverse(self) -> "IdentityLinearOperator":
        return self

    def sqrt(self) -> "IdentityLinearOperator":
        return self

    def abs(self) -> "IdentityLinearOperator":
        return self

    def exp(self) -> ConstantDiagLinearOperator:
        """e I, the elementwise exp of the diagonal (as the JAX package)."""
        return self._constant(torch.e)

    def log(self) -> LinearOperator:
        """log(1) = 0 on the diagonal: the zero operator."""
        from .zero import ZeroLinearOperator

        return ZeroLinearOperator(self.shape, dtype=self.dtype_, device=self.device_)

    def solve_triangular(self, rhs, *, upper: bool, left: bool = True, unitriangular: bool = False):
        return rhs

    def matmul(self, other):
        if isinstance(other, LinearOperator):
            return other
        return super().matmul(other)

    def __add__(self, other):
        if isinstance(other, IdentityLinearOperator):
            return self._constant(2.0)
        if isinstance(other, LinearOperator):
            return other.add_jitter(1.0)
        return super().__add__(other)

    def mul(self, other):
        if not isinstance(other, LinearOperator):
            c = torch.as_tensor(other, dtype=self.dtype_, device=self.device_)
            if c.ndim == 0:
                return ConstantDiagLinearOperator(c.expand(*self.batch_shape_, 1).clone(), diag_shape=self.diag_shape)
        return super().mul(other)

    def _expand_batch(self, batch_shape) -> "IdentityLinearOperator":
        return self._like(batch_shape=tuple(batch_shape))

    def _getitem(self, row_index, col_index, *batch_indices):
        if isinstance(row_index, slice) and isinstance(col_index, slice) and row_index == col_index and not batch_indices:
            return self._like(diag_shape=len(range(*row_index.indices(self.diag_shape))))
        return DiagLinearOperator(self._diagonal())._getitem(row_index, col_index, *batch_indices)

    def zero_mean_mvn_samples(self, num_samples: int, *, generator: torch.Generator | None = None) -> torch.Tensor:
        from ..utils.random import randn

        return randn((num_samples, *self.batch_shape_, self.diag_shape), self.dtype_, self.device_, generator)
