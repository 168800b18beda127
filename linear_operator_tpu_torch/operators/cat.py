"""Lazy concatenation of operators along the rows, the columns or a batch dim
(counterpart of linear_operator_tpu/operators/cat.py).  All blocks live on
one device, as in the JAX package; a multi-device layout waits for the
port's ``parallel/``."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class CatLinearOperator(LinearOperator):
    def __init__(self, operators: tuple, cat_dim: int = -2):
        if cat_dim >= 0:
            raise ValueError("cat_dim must be negative (-1, -2, or a batch dim)")
        self.operators = tuple(operators)
        self.cat_dim = cat_dim

    def _shape(self) -> tuple[int, ...]:
        shapes = [op.shape for op in self.operators]
        ref = list(shapes[0])
        ref[self.cat_dim] = sum(s[self.cat_dim] for s in shapes)
        return tuple(ref)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        if self.cat_dim == -2:
            # rows: every block multiplies the whole rhs
            return torch.cat([op._matmul(rhs) for op in self.operators], dim=-2)
        if self.cat_dim == -1:
            # columns: each block takes its rows of the rhs, the results add
            out, offset = None, 0
            for op in self.operators:
                sz = op.shape[-1]
                piece = op._matmul(rhs[..., offset : offset + sz, :])
                out = piece if out is None else out + piece
                offset += sz
            return out
        # a batch dim: an rhs without it, or with it at size 1, is broadcast
        joint = torch.broadcast_shapes(self.batch_shape, rhs.shape[:-2])
        if tuple(rhs.shape[:-2]) != tuple(joint):
            rhs = rhs.expand(*joint, *rhs.shape[-2:])
        pieces, offset = [], 0
        for op in self.operators:
            sz = op.shape[self.cat_dim]
            pieces.append(op._matmul(rhs.narrow(rhs.ndim + self.cat_dim, offset, sz)))
            offset += sz
        return torch.cat(pieces, dim=self.cat_dim)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._transpose()._matmul(rhs)

    def _transpose(self) -> "CatLinearOperator":
        new_dim = {-2: -1, -1: -2}.get(self.cat_dim, self.cat_dim)
        return CatLinearOperator(tuple(op._transpose() for op in self.operators), cat_dim=new_dim)

    def _diagonal(self) -> torch.Tensor:
        if self.cat_dim not in (-1, -2):
            return torch.cat([op._diagonal() for op in self.operators], dim=self.cat_dim + 1)
        # each block's stretch of the diagonal by pointwise reads (of a
        # rectangular operator, the first min(m, n) entries)
        k = min(self.shape[-2:])
        pieces, offset = [], 0
        for op in self.operators:
            sz = max(0, min(op.shape[self.cat_dim], k - offset))
            local = torch.arange(sz, device=self.device)
            rows, cols = (local, local + offset) if self.cat_dim == -2 else (local + offset, local)
            nb = len(op.batch_shape)
            b_arrs = []
            for bd, s in enumerate(op.batch_shape):
                shp = [1] * (nb + 1)
                shp[bd] = s
                b_arrs.append(torch.arange(s, device=self.device).reshape(shp))
            shp_r = (1,) * nb + (sz,)
            vals = op._get_indices(rows.reshape(shp_r), cols.reshape(shp_r), *b_arrs)
            pieces.append(vals.expand(*self.batch_shape, sz))
            offset += op.shape[self.cat_dim]
        return torch.cat(pieces, dim=-1)

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """Each index read from the block that covers it (masked reads of
        every block)."""
        if self.cat_dim not in (-1, -2):
            return super()._get_indices(row_index, col_index, *batch_indices)
        cat_idx = row_index if self.cat_dim == -2 else col_index
        out, offset = None, 0
        for op in self.operators:
            sz = op.shape[self.cat_dim]
            mask = (cat_idx >= offset) & (cat_idx < offset + sz)
            local = torch.clamp(cat_idx - offset, 0, sz - 1)
            if self.cat_dim == -2:
                vals = op._get_indices(local, col_index, *batch_indices)
            else:
                vals = op._get_indices(row_index, local, *batch_indices)
            out = torch.where(mask, vals, torch.zeros_like(vals)) if out is None else torch.where(mask, vals, out)
            offset += sz
        return out

    def to_dense(self) -> torch.Tensor:
        return torch.cat([op.to_dense() for op in self.operators], dim=self.cat_dim)

    def _expand_batch(self, batch_shape) -> LinearOperator:
        if self.cat_dim in (-1, -2):
            return CatLinearOperator(tuple(op._expand_batch(batch_shape) for op in self.operators), cat_dim=self.cat_dim)
        return super()._expand_batch(batch_shape)

    def _split_cat_slice(self, sl: slice):
        """[(block, local slice), ...] covering a slice along the cat dim, in
        output order; None for a negative step."""
        start, stop, step = sl.indices(self.shape[self.cat_dim])
        if step <= 0:
            return None
        out, offset = [], 0
        for bi, op in enumerate(self.operators):
            sz = op.shape[self.cat_dim]
            t_lo = max(0, -(-(offset - start) // step))  # first t with start + t step >= offset
            t_hi = max(0, -(-(min(stop, offset + sz) - start) // step))
            if t_hi > t_lo:
                lo = start + t_lo * step - offset
                hi = start + (t_hi - 1) * step - offset + 1
                out.append((bi, slice(lo, hi, step)))
            offset += sz
        return out

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        """A slice along the cat dim goes to the blocks it covers."""
        cat_index = row_index if self.cat_dim == -2 else col_index if self.cat_dim == -1 else None
        if isinstance(cat_index, slice):
            split = self._split_cat_slice(cat_index)
            if split:
                pieces = [
                    self.operators[bi]._getitem(local, col_index, *batch_indices)
                    if self.cat_dim == -2
                    else self.operators[bi]._getitem(row_index, local, *batch_indices)
                    for bi, local in split
                ]
                return pieces[0] if len(pieces) == 1 else CatLinearOperator(tuple(pieces), cat_dim=self.cat_dim)
        return super()._getitem(row_index, col_index, *batch_indices)


def cat(operators, dim: int = 0) -> CatLinearOperator:
    """The lazy concatenation of ``operators`` along ``dim``."""
    if dim >= 0:
        dim = dim - operators[0].ndim
    return CatLinearOperator(tuple(operators), cat_dim=dim)
