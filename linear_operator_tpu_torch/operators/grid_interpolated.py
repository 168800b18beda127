"""Grid-structured interpolated operator: W_l K_grid W_r^T with Kronecker
rows (counterpart of linear_operator_tpu/operators/grid_interpolated.py).

The interpolation rows are Kronecker products of per-dimension stencils, as
SKI builds them on a regular grid.  The JAX package applies W and W^T by
one-hot panel products, because dynamic indexing is slow on a TPU.  The port
flattens the stencils once, here, into (n, prod k_d) rows and applies them
by one gather and one scatter-add (``utils/sparse.py``): on an H100 the
gather and ``index_add`` beat the one-hot panels 40-180 times at
n = 200,000 (``chip_smoke.py`` phase 15 times both).  Everything else is the
flat ``InterpolatedLinearOperator``'s.
"""

from __future__ import annotations

import math

from ..utils.sparse import flatten_grid_interp
from ._linear_operator import LinearOperator
from .interpolated import InterpolatedLinearOperator


class GridInterpolatedLinearOperator(InterpolatedLinearOperator):
    def __init__(self, base: LinearOperator, left_indices, left_values, right_indices, right_values, sizes):
        # base: the (M, M) grid operator, M = prod(sizes); the stencils are
        # per-dimension (n, k_d) index and value tensors
        sizes = tuple(int(s) for s in sizes)
        if math.prod(sizes) != base.shape[-1]:
            raise ValueError(f"grid sizes {sizes} do not match base shape {base.shape}")
        if len(left_indices) != len(sizes) or len(right_indices) != len(sizes):
            raise ValueError("need one index/value stencil per grid dimension")
        li, lv = flatten_grid_interp(left_indices, left_values, sizes)
        ri, rv = flatten_grid_interp(right_indices, right_values, sizes)
        super().__init__(base, li, lv, ri, rv)
        self.sizes = sizes
