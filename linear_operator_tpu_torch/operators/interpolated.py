"""Interpolated operator W_left K W_right^T, the SKI / KISS-GP backbone
(counterpart of linear_operator_tpu/operators/interpolated.py).

W_left (*b, n_l, M) and W_right (*b, n_r, M) are interpolation matrices with
k nonzeros a row, stored as (indices, values) pairs and applied by gather
and scatter-add (``utils/sparse.py``); the grid operator K keeps its own
structure (Kronecker and Toeplitz on a regular grid).  The index tensors are
integer fields: ``_leaves`` walks them with the rest, and autograd never
asks for their gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.broadcasting import broadcast_shapes
from ..utils.sparse import left_interp, left_t_interp
from ._linear_operator import LinearOperator


class InterpolationMatrix(NamedTuple):
    """A fixed-sparsity row-interpolation matrix W: (*b, rows, grid_size)."""

    indices: torch.Tensor  # (*b, rows, k) int
    values: torch.Tensor  # (*b, rows, k)
    grid_size: int

    def matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return left_interp(self.indices, self.values, rhs)

    def t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return left_t_interp(self.indices, self.values, rhs, self.grid_size)


def _batch_aranges(batch, trailing: tuple[int, ...], device) -> list[torch.Tensor]:
    """One index tensor per batch dim, each expanded to (*batch, *trailing)."""
    out = []
    for i, b in enumerate(batch):
        shape = [1] * (len(batch) + len(trailing))
        shape[i] = b
        out.append(torch.arange(b, device=device).reshape(shape).expand(*batch, *trailing))
    return out


class InterpolatedLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator, left_indices, left_values, right_indices, right_values):
        self.base = base  # (*b, M, M) grid operator
        self.left_indices = left_indices  # (*b, n_l, k)
        self.left_values = left_values
        self.right_indices = right_indices  # (*b, n_r, k)
        self.right_values = right_values

    @property
    def _left(self) -> InterpolationMatrix:
        return InterpolationMatrix(self.left_indices, self.left_values, self.base.shape[-2])

    @property
    def _right(self) -> InterpolationMatrix:
        return InterpolationMatrix(self.right_indices, self.right_values, self.base.shape[-1])

    def _shape(self) -> tuple[int, ...]:
        batch = broadcast_shapes(
            tuple(self.base.batch_shape), tuple(self.left_indices.shape[:-2]), tuple(self.right_indices.shape[:-2])
        )
        return (*batch, self.left_indices.shape[-2], self.right_indices.shape[-2])

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        # W_l K W_r^T rhs: scatter, the grid operator's product, gather
        return self._left.matmul(self.base._matmul(self._right.t_matmul(rhs)))

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._right.matmul(self.base._t_matmul(self._left.t_matmul(rhs)))

    def _transpose(self) -> "InterpolatedLinearOperator":
        return InterpolatedLinearOperator(
            self.base._transpose(), self.right_indices, self.right_values, self.left_indices, self.left_values
        )

    def _diagonal(self) -> torch.Tensor:
        """diag_i = sum_{a,b} wl[i,a] wr[i,b] K[il[i,a], ir[i,b]]: k^2 pointwise
        reads of the grid operator."""
        li, ri = self.left_indices, self.right_indices
        bs = self.batch_shape
        n, k = li.shape[-2], li.shape[-1]
        rows = li[..., :, :, None].expand(*bs, n, k, k)
        cols = ri[..., :, None, :].expand(*bs, n, k, k)
        vals = self.base._get_indices(rows, cols, *_batch_aranges(bs, (n, k, k), li.device))
        w = self.left_values[..., :, :, None] * self.right_values[..., :, None, :]
        return torch.sum(vals * w, dim=(-2, -1))

    def to_dense(self) -> torch.Tensor:
        y = self._left.matmul(self.base.to_dense())  # (*b, n_l, M)
        return y @ _interp_to_dense(self._right).mT

    def _batch_expanded_interp(self):
        """The index and value tensors broadcast to the operator's batch
        shape (they may carry fewer or singleton batch dims)."""
        batch = self.batch_shape

        def bx(a):
            return a.expand(*batch, *a.shape[-2:])

        return bx(self.left_indices), bx(self.left_values), bx(self.right_indices), bx(self.right_values)

    def _interp_for(self, batch_indices):
        if batch_indices:
            return self._batch_expanded_interp()
        return self.left_indices, self.left_values, self.right_indices, self.right_values

    def _getitem(self, row_index, col_index, *batch_indices) -> "InterpolatedLinearOperator":
        li, lv, ri, rv = self._interp_for(batch_indices)
        base = self.base
        if batch_indices and base.batch_shape:
            # the base's own batch dims are indexed too
            base = base._expanded_to(self.batch_shape)._getitem(slice(None), slice(None), *batch_indices)
        return InterpolatedLinearOperator(
            base,
            li[(*batch_indices, row_index, slice(None))],
            lv[(*batch_indices, row_index, slice(None))],
            ri[(*batch_indices, col_index, slice(None))],
            rv[(*batch_indices, col_index, slice(None))],
        )

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        li_a, lv_a, ri_a, rv_a = self._interp_for(batch_indices)
        li = li_a[(*batch_indices, row_index, slice(None))]
        lv = lv_a[(*batch_indices, row_index, slice(None))]
        ri = ri_a[(*batch_indices, col_index, slice(None))]
        rv = rv_a[(*batch_indices, col_index, slice(None))]
        rows = li[..., :, None]
        cols = ri[..., None, :]
        shape = torch.broadcast_shapes(rows.shape, cols.shape)
        if batch_indices and any(torch.as_tensor(b).ndim for b in batch_indices):
            b_arrs = [torch.as_tensor(b)[..., None, None].expand(shape) for b in batch_indices]
        else:
            b_arrs = [torch.as_tensor(b, device=li.device).expand(shape) for b in batch_indices]
        # the base carries the joint batch before it takes batch indices
        base = self.base._expanded_to(self.batch_shape) if batch_indices else self.base
        vals = base._get_indices(rows.expand(shape), cols.expand(shape), *b_arrs)
        w = lv[..., :, None] * rv[..., None, :]
        return torch.sum(vals * w, dim=(-2, -1))


def _interp_to_dense(w: InterpolationMatrix) -> torch.Tensor:
    """The dense (*b, rows, grid_size) matrix of an interpolation matrix
    (repeated indices add)."""
    rows, k = w.indices.shape[-2], w.indices.shape[-1]
    batch = broadcast_shapes(tuple(w.indices.shape[:-2]), tuple(w.values.shape[:-2]))
    full = (*batch, rows, k)
    device = w.indices.device
    row_ids = torch.arange(rows, device=device)[:, None].expand(full)
    out = torch.zeros((*batch, rows, w.grid_size), dtype=w.values.dtype, device=device)
    index = (*_batch_aranges(batch, (rows, k), device), row_ids, w.indices.expand(full))
    return out.index_put(index, w.values.expand(full), accumulate=True)
