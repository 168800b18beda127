"""Interpolation matrices applied by gather and scatter-add (counterpart of
linear_operator_tpu/utils/sparse.py).

An interpolation matrix W has a fixed number k of nonzeros per row, stored as
(indices, values) pairs of shape (*b, n, k).  W @ rhs gathers k rows of rhs
per output row and sums them weighted (``left_interp``); W^T @ rhs adds each
weighted row of rhs into its k grid rows with one ``index_add``
(``left_t_interp``).  Batch dims fold into the row index, so either
direction is one gather or one scatter whatever the batch.
"""

from __future__ import annotations

import torch

from .broadcasting import broadcast_shapes


def _flat_rows(indices: torch.Tensor, batch, rows: int) -> torch.Tensor:
    """Indices (*b', n, k) broadcast to ``batch`` and offset by ``rows`` per
    batch element: row numbers into the (prod(batch) * rows)-row stack."""
    n, k = indices.shape[-2:]
    idx = indices.expand(*batch, n, k).reshape(-1, n, k)
    offsets = torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype) * rows
    return idx + offsets[:, None, None]


def left_interp(indices: torch.Tensor, values: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """W @ rhs for W (*b, n, M) with k nonzeros a row.

    indices/values: (*b, n, k); rhs: (*b, M, t) -> (*b, n, t)."""
    batch = broadcast_shapes(tuple(indices.shape[:-2]), tuple(values.shape[:-2]), tuple(rhs.shape[:-2]))
    n, k = indices.shape[-2:]
    m, t = rhs.shape[-2:]
    if batch:
        flat = rhs.expand(*batch, m, t).reshape(-1, t)
        gathered = flat[_flat_rows(indices, batch, m)].reshape(*batch, n, k, t)
    else:
        gathered = rhs[indices]  # (n, k, t)
    return torch.sum(gathered * values[..., :, :, None], dim=-2)


def left_t_interp(indices: torch.Tensor, values: torch.Tensor, rhs: torch.Tensor, output_dim: int) -> torch.Tensor:
    """W^T @ rhs: a scatter-add of the weighted rows of rhs into the grid.

    indices/values: (*b, n, k); rhs: (*b, n, t) -> (*b, output_dim, t)."""
    batch = broadcast_shapes(tuple(indices.shape[:-2]), tuple(values.shape[:-2]), tuple(rhs.shape[:-2]))
    n, k = indices.shape[-2:]
    t = rhs.shape[-1]
    contrib = (values[..., :, :, None] * rhs[..., :, None, :]).to(rhs.dtype)  # (*b, n, k, t)
    if batch:
        idx = _flat_rows(indices, batch, output_dim).reshape(-1)
        contrib = contrib.expand(*batch, n, k, t)
        size = output_dim * idx.numel() // (n * k)
    else:
        idx = indices.reshape(-1)
        size = output_dim
    out = torch.zeros((size, t), dtype=rhs.dtype, device=rhs.device).index_add(0, idx, contrib.reshape(-1, t))
    return out.reshape(*batch, output_dim, t)


def flatten_grid_interp(dim_indices, dim_values, sizes):
    """Per-dimension (*b, n, k_d) stencils -> flat (*b, n, prod k_d) indices
    and values over the row-major grid of ``sizes``: row i of W is the
    Kronecker product of the per-dimension rows."""
    sizes = tuple(int(s) for s in sizes)
    flat_idx, flat_w = dim_indices[0], dim_values[0]
    for d in range(1, len(sizes)):
        fi = flat_idx[..., :, None] * sizes[d] + dim_indices[d][..., None, :]
        flat_idx = fi.reshape(*fi.shape[:-2], -1)
        fw = flat_w[..., :, None] * dim_values[d][..., None, :]
        flat_w = fw.reshape(*fw.shape[:-2], -1)
    return flat_idx, flat_w


def bdsmm(sparse_op, dense: torch.Tensor) -> torch.Tensor:
    """Batched (interpolation-)sparse @ dense: an InterpolationMatrix by
    ``left_interp``, anything else by a dense product."""
    from ..operators.interpolated import InterpolationMatrix

    if isinstance(sparse_op, InterpolationMatrix):
        return left_interp(sparse_op.indices, sparse_op.values, dense)
    return torch.matmul(torch.as_tensor(sparse_op), dense)
