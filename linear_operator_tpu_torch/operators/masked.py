"""A row and column selection of a base operator (counterpart of
linear_operator_tpu/operators/masked.py).  The selection is held as integer
index tensors on the base's device (``from_masks`` takes boolean masks); the
mat-vec scatters the rhs into the full space, applies the base and gathers
the selected rows."""

from __future__ import annotations

import numpy as np
import torch

from ._linear_operator import LinearOperator


class MaskedLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator, row_idx: torch.Tensor, col_idx: torch.Tensor):
        self.base = base
        self.row_idx = row_idx  # (r,) selected rows
        self.col_idx = col_idx  # (c,) selected columns

    @staticmethod
    def from_masks(base: LinearOperator, row_mask, col_mask) -> "MaskedLinearOperator":
        def idx(mask):
            mask = torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor) else mask, dtype=torch.bool)
            return torch.nonzero(mask.to(base.device))[:, 0]

        return MaskedLinearOperator(base, idx(row_mask), idx(col_mask))

    def _shape(self) -> tuple[int, ...]:
        return (*self.base.batch_shape, self.row_idx.shape[0], self.col_idx.shape[0])

    @staticmethod
    def _scatter_apply(apply, rhs, full_rows: int, into: torch.Tensor, out_idx: torch.Tensor) -> torch.Tensor:
        full = torch.zeros((*rhs.shape[:-2], full_rows, rhs.shape[-1]), dtype=rhs.dtype, device=rhs.device)
        full = full.index_copy(-2, into, rhs)
        return apply(full).index_select(-2, out_idx)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._scatter_apply(self.base._matmul, rhs, self.base.shape[-1], self.col_idx, self.row_idx)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._scatter_apply(self.base._t_matmul, rhs, self.base.shape[-2], self.row_idx, self.col_idx)

    def _transpose(self) -> "MaskedLinearOperator":
        return MaskedLinearOperator(self.base._transpose(), self.col_idx, self.row_idx)

    def _diagonal(self) -> torch.Tensor:
        k = min(self.row_idx.shape[0], self.col_idx.shape[0])
        bs = tuple(self.base.batch_shape)
        ri = self.row_idx[:k].expand(*bs, k)
        ci = self.col_idx[:k].expand(*bs, k)
        b_arrs = []
        for i, b in enumerate(bs):
            shape = [1] * (len(bs) + 1)
            shape[i] = b
            b_arrs.append(torch.arange(b, device=ri.device).reshape(shape).expand(*bs, k))
        return self.base._get_indices(ri, ci, *b_arrs)

    def to_dense(self) -> torch.Tensor:
        return self.base.to_dense().index_select(-2, self.row_idx).index_select(-1, self.col_idx)

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        return self.base._get_indices(self.row_idx[row_index], self.col_idx[col_index], *batch_indices)
