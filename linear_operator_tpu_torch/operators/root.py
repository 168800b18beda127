"""Root operators: K = R R^T given the root R (counterpart of
linear_operator_tpu/operators/root.py)."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class RootLinearOperator(LinearOperator):
    def __init__(self, root: LinearOperator):
        if not isinstance(root, LinearOperator):
            from .dense import DenseLinearOperator

            root = DenseLinearOperator(root)
        self.root = root  # (*b, n, k)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        # two skinny products instead of forming R R^T
        return self.root._matmul(self.root._t_matmul(rhs))

    def _shape(self) -> tuple[int, ...]:
        rs = self.root.shape
        return (*rs[:-1], rs[-2])

    def _transpose(self) -> "RootLinearOperator":
        return self

    def _diagonal(self) -> torch.Tensor:
        root = self.root.to_dense()
        return torch.sum(root * root, dim=-1)

    def to_dense(self) -> torch.Tensor:
        root = self.root.to_dense()
        return root @ root.mT

    def _root_structure(self) -> LinearOperator:
        return self.root

    def root_decomposition(self, method=None, *, generator=None) -> "RootLinearOperator":
        return self

    def _expand_batch(self, batch_shape) -> "RootLinearOperator":
        return type(self)(self.root._expand_batch(batch_shape))

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        """K[i, j] = R[i, :] R[j, :]^T: the root's rows sliced."""
        from .matmul import MatmulLinearOperator

        left = self.root._getitem(row_index, slice(None), *batch_indices)
        if isinstance(row_index, slice) and isinstance(col_index, slice) and row_index == col_index:
            # a subclass with a constraint on its root (Chol's triangular
            # one) becomes a plain root operator: the sliced rows are a root
            cls = type(self) if type(self) in (RootLinearOperator, LowRankRootLinearOperator) else RootLinearOperator
            return cls(left)
        right = self.root._getitem(col_index, slice(None), *batch_indices)
        return MatmulLinearOperator(left, right._transpose())

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        root = self.root.to_dense()
        left = root[(*batch_indices, row_index, slice(None))]
        right = root[(*batch_indices, col_index, slice(None))]
        return torch.sum(left * right, dim=-1)


class LowRankRootLinearOperator(RootLinearOperator):
    """A genuinely low-rank root: adding a diagonal gives the Woodbury
    structured ``LowRankRootAddedDiagLinearOperator``."""

    def __add__(self, other):
        from .diag import DiagLinearOperator
        from .low_rank_root_added_diag import LowRankRootAddedDiagLinearOperator

        if isinstance(other, DiagLinearOperator):
            return LowRankRootAddedDiagLinearOperator(self, other)
        return super().__add__(other)
