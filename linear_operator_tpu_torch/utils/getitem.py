"""Tensor-style indexing of lazy operators (counterpart of
linear_operator_tpu/utils/getitem.py).

Semantics, torch's:
* slices on both matrix dims -> a lazy operator (``op._getitem``);
* a 1-D index tensor on one matrix dim, a slice on the other and basic batch
  indices -> a lazy row (column) selection (``op._select_rows``);
* any other int or index tensor on a matrix dim -> dense values, gathered
  pointwise through ``op._get_indices``;
* batch dims take ints, slices and index tensors, and stay lazy when the
  matrix dims do.

Index tensors may be ``torch.Tensor``, numpy arrays or lists; numpy ints are
ints.  Index tensors are moved to the operator's device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _is_int(ix: Any) -> bool:
    return isinstance(ix, (int, np.integer)) and not isinstance(ix, bool)


def _is_array_index(ix: Any) -> bool:
    if isinstance(ix, torch.Tensor):
        return True
    return isinstance(ix, (np.ndarray, list))


def _as_tensor(ix, device) -> torch.Tensor:
    t = ix if isinstance(ix, torch.Tensor) else torch.as_tensor(np.asarray(ix))
    return t.to(device) if device is not None else t


def _as_index_tensor(ix, dim_size: int, device) -> torch.Tensor:
    if isinstance(ix, slice):
        return torch.arange(*ix.indices(dim_size), device=device)
    t = _as_tensor(ix, device)
    return torch.where(t < 0, t + dim_size, t)


def _shape_of(ix) -> tuple[int, ...]:
    return tuple(ix.shape) if isinstance(ix, torch.Tensor) else np.shape(np.asarray(ix))


def sliced_shape(shape, *indices) -> tuple[int, ...]:
    """The shape ``indices`` leave of ``shape``: ints drop their dim, slices
    resize it, index tensors broadcast into one advanced block, which sits at
    the first tensor's position unless a slice separates two tensors (then it
    moves to the front)."""
    is_arr = [_is_array_index(ix) for ix in indices]
    if not any(is_arr):
        return tuple(len(range(*ix.indices(size))) for ix, size in zip(indices, shape) if isinstance(ix, slice))
    block = tuple(np.broadcast_shapes(*[_shape_of(ix) for ix, f in zip(indices, is_arr) if f]))
    first = is_arr.index(True)
    last = len(is_arr) - 1 - is_arr[::-1].index(True)
    front = any(isinstance(ix, slice) for ix in indices[first + 1 : last])
    out: list[int] = list(block) if front else []
    placed = front
    for ix, size, f in zip(indices, shape, is_arr):
        if isinstance(ix, slice):
            out.append(len(range(*ix.indices(size))))
        elif f and not placed:
            out.extend(block)
            placed = True
    return tuple(out)


def _unsqueeze_at(result, pos: int):
    from ..operators._linear_operator import LinearOperator

    if isinstance(result, LinearOperator):
        if pos > result.ndim - 2:
            # a new axis inside or after the matrix dims: no longer a batch
            # of matrices
            return result.to_dense().unsqueeze(pos)
        return result.unsqueeze(pos)
    return result.unsqueeze(pos)


def _with_newaxes(op, index: tuple):
    """Index without the ``None`` entries, then insert their axes at the
    positions torch gives them."""
    entries = list(index)

    def arr_ndim(e) -> int:
        t = _as_tensor(e, None)
        return 1 if t.dtype == torch.bool else t.ndim

    arr_pos = [i for i, e in enumerate(entries) if _is_array_index(e)]
    block_ndim = max((arr_ndim(entries[i]) for i in arr_pos), default=0)
    front = len(arr_pos) >= 2 and any(
        isinstance(entries[i], slice) or entries[i] is None for i in range(arr_pos[0] + 1, arr_pos[-1])
    )
    stripped = [e for e in entries if e is not None]
    sp = [i for i, e in enumerate(stripped) if _is_array_index(e)]
    stripped_front = len(sp) >= 2 and any(isinstance(stripped[i], slice) for i in range(sp[0] + 1, sp[-1]))
    result = normalize_getitem_index(op, tuple(stripped))

    if front and not stripped_front:
        # None was the only separator: torch puts the block in front
        pre = sum(1 for e in stripped[: sp[0]] if isinstance(e, slice))
        if pre > 0:
            if not isinstance(result, torch.Tensor):
                raise IndexError("newaxis separating advanced indices is not supported for lazy results")
            result = torch.movedim(result, tuple(range(pre, pre + block_ndim)), tuple(range(block_ndim)))

    positions = []
    out_pos = block_ndim if (arr_pos and front) else 0
    seen_block = False
    for e in entries:
        if e is None:
            positions.append(out_pos)
            out_pos += 1
        elif isinstance(e, slice):
            out_pos += 1
        elif _is_array_index(e) and not front and not seen_block:
            out_pos += block_ndim
            seen_block = True
    for pos in positions:
        result = _unsqueeze_at(result, pos)
    return result


def normalize_getitem_index(op, index):
    """``LinearOperator.__getitem__`` (see the module docstring)."""
    if not isinstance(index, tuple):
        index = (index,)
    device = op.device

    if any(ix is Ellipsis for ix in index):
        # identity scans: == on an index tensor is elementwise
        pos = next(i for i, ix in enumerate(index) if ix is Ellipsis)
        if sum(1 for ix in index if ix is Ellipsis) > 1:
            raise IndexError("only one Ellipsis allowed")
        n_consuming = sum(1 for ix in index if ix is not None and ix is not Ellipsis)
        index = index[:pos] + (slice(None),) * (op.ndim - n_consuming) + index[pos + 1 :]

    if any(ix is None for ix in index):
        return _with_newaxes(op, index)

    if len(index) > op.ndim:
        raise IndexError(f"too many indices ({len(index)}) for operator of dim {op.ndim}")
    index = index + (slice(None),) * (op.ndim - len(index))

    def mask_to_indices(ix, size):
        if _is_array_index(ix):
            t = _as_tensor(ix, device)
            if t.dtype == torch.bool:
                if t.ndim != 1:
                    raise IndexError("boolean mask indices must be 1-D")
                if t.shape[0] != size:
                    raise IndexError(f"boolean mask length {t.shape[0]} does not match dimension size {size}")
                return torch.nonzero(t)[:, 0]
            return t
        if isinstance(ix, np.integer):
            return int(ix)
        return ix

    index = tuple(mask_to_indices(ix, s) for ix, s in zip(index, op.shape))
    # torch slices take no negative step: such a slice becomes its index
    # tensor (on a matrix dim, applied as a lazy selection of its own)
    reversed_dims = {i for i, ix in enumerate(index) if isinstance(ix, slice) and (ix.step or 1) < 0}
    index = tuple(
        torch.arange(*ix.indices(s), device=device) if i in reversed_dims else ix
        for i, (ix, s) in enumerate(zip(index, op.shape))
    )
    batch_indices = index[:-2]
    row_index, col_index = index[-2], index[-1]

    if isinstance(row_index, slice) and isinstance(col_index, slice):
        # The operators' _getitem index their tensors with numpy placement
        # (ints as 0-d advanced indices), the contract is torch's (ints are
        # basic); they differ only when batch ints mix with tensors, so the
        # ints go first.
        if any(_is_int(b) for b in batch_indices) and any(_is_array_index(b) for b in batch_indices):
            ints_first = tuple(b if _is_int(b) else slice(None) for b in batch_indices)
            reduced = op._getitem(slice(None), slice(None), *ints_first)
            rest = tuple(b for b in batch_indices if not _is_int(b))
            return normalize_getitem_index(reduced, (*rest, row_index, col_index))
        return op._getitem(row_index, col_index, *batch_indices)

    shape = op.shape
    any_batch_array = any(_is_array_index(b) for b in batch_indices)
    row_is_arr = _is_array_index(row_index)
    col_is_arr = _is_array_index(col_index)

    nd = op.ndim
    if not any_batch_array and row_is_arr and col_is_arr and {nd - 2, nd - 1} & reversed_dims:
        # a reversed slice and a 1-D tensor (or two reversed slices) take
        # the outer product of their indices: two lazy selections
        if row_index.ndim == 1 and col_index.ndim == 1:
            base = op._getitem(slice(None), slice(None), *batch_indices)
            return base._select_rows(row_index)._select_cols(col_index)

    # lazy selection: one matrix dim by a 1-D tensor, the other a slice
    if not any_batch_array and (row_is_arr ^ col_is_arr):
        arr = row_index if row_is_arr else col_index
        other = col_index if row_is_arr else row_index
        if arr.ndim == 1 and isinstance(other, slice):
            dim_size = shape[-2] if row_is_arr else shape[-1]
            arr = torch.where(arr < 0, arr + dim_size, arr)
            base = op._getitem(
                slice(None) if row_is_arr else row_index,
                slice(None) if col_is_arr else col_index,
                *batch_indices,
            )
            return base._select_rows(arr) if row_is_arr else base._select_cols(arr)

    if any_batch_array:
        return _gather_with_batch_arrays(op, batch_indices, row_index, col_index)
    return _gather_matrix_arrays(op, batch_indices, row_index, col_index)


def _gather_with_batch_arrays(op, batch_indices, row_index, col_index):
    """Torch's advanced indexing: tensors broadcast jointly into one block,
    ints are basic and drop their dim, slices keep theirs; the block sits at
    the first tensor unless a slice separates two tensors."""
    device = op.device
    entries = list(batch_indices) + [row_index, col_index]
    sizes = list(op.shape)
    is_arr = [_is_array_index(e) for e in entries]
    block = tuple(np.broadcast_shapes(*[tuple(e.shape) for e, f in zip(entries, is_arr) if f]))
    first = is_arr.index(True)
    last = len(is_arr) - 1 - is_arr[::-1].index(True)
    front = any(isinstance(e, slice) for e in entries[first + 1 : last])

    out_shape: list[int] = []
    slice_axis: dict[int, int] = {}
    block_axes: list[int] | None = None
    if front:
        block_axes = list(range(len(block)))
        out_shape.extend(block)
    for pos, e in enumerate(entries):
        if isinstance(e, slice):
            slice_axis[pos] = len(out_shape)
            out_shape.append(len(range(*e.indices(sizes[pos]))))
        elif is_arr[pos] and block_axes is None:
            block_axes = list(range(len(out_shape), len(out_shape) + len(block)))
            out_shape.extend(block)
    out = tuple(out_shape)

    def full(pos: int) -> torch.Tensor:
        e = entries[pos]
        a = _as_index_tensor(e, sizes[pos], device)
        s = [1] * len(out)
        if isinstance(e, slice):
            s[slice_axis[pos]] = a.shape[0]
        elif is_arr[pos]:
            a = a.expand(block)
            for ax, size in zip(block_axes, block):
                s[ax] = size
        return a.reshape(s).expand(out)

    fulls = [full(p) for p in range(len(entries))]
    return op._get_indices(fulls[-2], fulls[-1], *fulls[:-2])


def _gather_matrix_arrays(op, batch_indices, row_index, col_index):
    """Basic batch indices (slices keep their axes, ints drop them); the
    advanced matrix indices broadcast into one block, while a slice on the
    other matrix dim keeps an axis of its own."""
    device = op.device
    shape = op.shape
    row_arr = _as_index_tensor(row_index, shape[-2], device)
    col_arr = _as_index_tensor(col_index, shape[-1], device)
    batch_arrs = [_as_index_tensor(b, s, device) for b, s in zip(batch_indices, shape[:-2])]
    row_from_slice = isinstance(row_index, slice)
    col_from_slice = isinstance(col_index, slice)
    adv_parts = ([] if row_from_slice else [tuple(row_arr.shape)]) + ([] if col_from_slice else [tuple(col_arr.shape)])
    adv_shape = tuple(np.broadcast_shapes(*adv_parts)) if adv_parts else ()
    slice_dims = [a.shape[0] for a, ix in zip(batch_arrs, batch_indices) if not _is_int(ix)]
    n_slice = len(slice_dims)

    if row_from_slice and not col_from_slice:
        out_shape = (*slice_dims, row_arr.shape[0], *adv_shape)
        row_axes, adv_start = [n_slice], n_slice + 1
    elif col_from_slice and not row_from_slice:
        out_shape = (*slice_dims, *adv_shape, col_arr.shape[0])
        col_axes, adv_start = [n_slice + len(adv_shape)], n_slice
    else:
        out_shape = (*slice_dims, *adv_shape)
        adv_start = n_slice
    adv_axes = list(range(adv_start, adv_start + len(adv_shape)))

    def place(a: torch.Tensor, axes) -> torch.Tensor:
        s = [1] * len(out_shape)
        for ax, size in zip(axes, a.shape):
            s[ax] = size
        return a.reshape(s).expand(out_shape)

    row_full = place(row_arr, row_axes) if row_from_slice else place(row_arr.expand(adv_shape), adv_axes)
    col_full = place(col_arr, col_axes) if col_from_slice else place(col_arr.expand(adv_shape), adv_axes)
    expanded_batch = []
    pos = 0
    for a, ix in zip(batch_arrs, batch_indices):
        if _is_int(ix):
            expanded_batch.append(a.expand(out_shape))
        else:
            expanded_batch.append(place(a, [pos]))
            pos += 1
    return op._get_indices(row_full, col_full, *expanded_batch)
