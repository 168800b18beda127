"""Shape/broadcast helpers (counterpart of linear_operator_tpu/utils/broadcasting.py)."""

from __future__ import annotations

import numpy as np


def broadcast_shapes(*shapes: tuple[int, ...]) -> tuple[int, ...]:
    """NumPy-style broadcast of batch shapes; raises on mismatch."""
    return tuple(np.broadcast_shapes(*shapes))


def matmul_broadcast_shape(
    shape_a: tuple[int, ...], shape_b: tuple[int, ...]
) -> tuple[int, ...]:
    """Result shape of a (batched) matmul."""
    if len(shape_b) == 1:
        if shape_a[-1] != shape_b[0]:
            raise RuntimeError(f"Incompatible matmul shapes {shape_a} x {shape_b}")
        return shape_a[:-1]
    if len(shape_a) == 1:
        if shape_a[0] != shape_b[-2]:
            raise RuntimeError(f"Incompatible matmul shapes {shape_a} x {shape_b}")
        return shape_b[:-2] + shape_b[-1:]
    if shape_a[-1] != shape_b[-2]:
        raise RuntimeError(f"Incompatible matmul shapes {shape_a} x {shape_b}")
    batch = broadcast_shapes(shape_a[:-2], shape_b[:-2])
    return batch + (shape_a[-2], shape_b[-1])



def pad_with_singletons(
    shape: tuple[int, ...], num_singletons_before: int, num_singletons_after: int
) -> tuple[int, ...]:
    """``shape`` with ``num_singletons_before`` 1s in front and
    ``num_singletons_after`` behind."""
    return (1,) * num_singletons_before + tuple(shape) + (1,) * num_singletons_after
