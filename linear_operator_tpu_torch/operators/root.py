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

    def _root_structure(self) -> LinearOperator:
        return self.root

    def root_decomposition(self, method=None, *, generator=None) -> "RootLinearOperator":
        return self

    def _expand_batch(self, batch_shape) -> "RootLinearOperator":
        return type(self)(self.root._expand_batch(batch_shape))


class LowRankRootLinearOperator(RootLinearOperator):
    """A genuinely low-rank root: adding a diagonal gives the Woodbury
    structured ``LowRankRootAddedDiagLinearOperator``."""

    def __add__(self, other):
        from .diag import DiagLinearOperator
        from .low_rank_root_added_diag import LowRankRootAddedDiagLinearOperator

        if isinstance(other, DiagLinearOperator):
            return LowRankRootAddedDiagLinearOperator(self, other)
        return super().__add__(other)
