"""PSD operator represented by its Cholesky factor (counterpart of
linear_operator_tpu/operators/chol.py)."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ._linear_operator import LinearOperator
from .root import RootLinearOperator
from .triangular import TriangularLinearOperator


class CholLinearOperator(RootLinearOperator):
    """K = L L^T where ``root`` is a TriangularLinearOperator (lower, or
    upper for the inverse's root L^{-T})."""

    def __init__(self, root):
        if not isinstance(root, TriangularLinearOperator):
            if not isinstance(root, (torch.Tensor, np.ndarray)):
                raise TypeError("CholLinearOperator requires a TriangularLinearOperator root")
            # a raw triangular tensor is accepted, with a DeprecationWarning,
            # and its triangle read from its entries
            warnings.warn(
                "chol argument to CholLinearOperator should be a "
                "TriangularLinearOperator; pass one explicitly.",
                DeprecationWarning,
                stacklevel=2,
            )
            root = torch.as_tensor(root)
            if torch.equal(torch.tril(root), root):
                upper = False
            elif torch.equal(torch.triu(root), root):
                upper = True
            else:
                raise ValueError("chol must be either lower or upper triangular")
            root = TriangularLinearOperator(root, upper=upper)
        super().__init__(root)

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.root._cholesky_solve(rhs)

    def _logdet_structure(self) -> torch.Tensor:
        """2 sum(log diag L)."""
        return 2.0 * torch.sum(torch.log(torch.abs(self.root._diagonal())), dim=-1)

    def _inv_quad_logdet_structure(self, rhs, logdet):
        """inv_quad by one triangular solve: |L^{-1} rhs|^2."""
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        if rhs is None:
            iq = zeros
        else:
            y = self.root._solve_structure(rhs)
            iq = torch.sum(y * y, dim=-2)
        return iq, self._logdet_structure() if logdet else zeros

    def _cholesky_impl(self, upper: bool = False) -> LinearOperator:
        if upper == self.root.upper:
            return self.root
        return self.root._transpose()

    def _root_inv_structure(self) -> LinearOperator:
        """A root of K^{-1}: L^{-T}."""
        return self.root.inverse()._transpose()

    def inverse(self) -> "CholLinearOperator":
        return CholLinearOperator(self.root.inverse()._transpose())
