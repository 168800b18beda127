"""Lazy ``repeat`` (tiling) of batch dims (counterpart of
linear_operator_tpu/operators/batch_repeat.py).  The rhs's repeated batch
dims are split into (repeat, base) pairs and the repeat dims moved to the
front, where they broadcast against the base's batch; the base's product runs
once per base batch element whatever the repeats."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class BatchRepeatLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator, batch_repeat: tuple = (1,)):
        self.base = base
        self.batch_repeat = tuple(batch_repeat)

    def _padded(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        bb = tuple(self.base.batch_shape)
        reps = self.batch_repeat
        width = max(len(bb), len(reps))
        return (1,) * (width - len(reps)) + reps, (1,) * (width - len(bb)) + bb

    def _shape(self) -> tuple[int, ...]:
        reps, bb = self._padded()
        return (*(r * b for r, b in zip(reps, bb)), *self.base.matrix_shape)

    def _through_base(self, rhs: torch.Tensor, base_fn) -> torch.Tensor:
        """Split the (rep * base) batch dims, apply ``base_fn`` broadcasting
        over the leading repeat dims, fold back."""
        reps, bb = self._padded()
        width = len(reps)
        n, t = rhs.shape[-2:]
        extra = rhs.ndim - 2 - width
        if extra > 0:
            # leading rhs batch dims beyond the operator's: one pass each
            lead = tuple(torch.broadcast_shapes(rhs.shape[:-2], (1,) * extra + tuple(self.batch_shape)))
            flat = rhs.expand(*lead, n, t).reshape(-1, *self.batch_shape, n, t)
            out = torch.stack([self._through_base(r, base_fn) for r in flat])
            return out.reshape(*lead[:extra], *out.shape[1:])
        rhs = rhs.expand(*self.batch_shape, n, t)
        inter = []
        for r, b in zip(reps, bb):
            inter += [r, b]
        x = rhs.reshape(*inter, n, t)
        perm = [2 * i for i in range(width)] + [2 * i + 1 for i in range(width)]
        x = x.permute(*perm, 2 * width, 2 * width + 1)
        out = base_fn(x)  # (*reps, *bb, m, t)
        m = out.shape[-2]
        inv = []
        for i in range(width):
            inv += [i, width + i]
        out = out.permute(*inv, 2 * width, 2 * width + 1)
        return out.reshape(*self.batch_shape, m, t)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._through_base(rhs, self.base._matmul)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._through_base(rhs, self.base._t_matmul)

    def _transpose(self) -> "BatchRepeatLinearOperator":
        return BatchRepeatLinearOperator(self.base._transpose(), batch_repeat=self.batch_repeat)

    def _diagonal(self) -> torch.Tensor:
        reps, _ = self._padded()
        return self.base._diagonal().repeat(*reps, 1)

    def to_dense(self) -> torch.Tensor:
        reps, _ = self._padded()
        return self.base.to_dense().repeat(*reps, 1, 1)

    def _cholesky_impl(self, upper: bool = False):
        from .dense import DenseLinearOperator
        from .triangular import TriangularLinearOperator

        inner = self.base._cholesky_impl(upper=upper)
        tri = inner.tensor if isinstance(inner, TriangularLinearOperator) else inner
        if not isinstance(tri, LinearOperator):
            tri = DenseLinearOperator(tri)
        return TriangularLinearOperator(BatchRepeatLinearOperator(tri, batch_repeat=self.batch_repeat), upper=upper)

    def _solve_structure(self, rhs: torch.Tensor):
        if type(self.base)._solve_structure is LinearOperator._solve_structure:
            return None

        class _NoFastPath(Exception):
            pass

        def fn(x):
            out = self.base._solve_structure(x)
            if out is None:
                raise _NoFastPath
            return out

        try:
            return self._through_base(rhs, fn)
        except _NoFastPath:
            return None

    def repeat(self, *sizes) -> "BatchRepeatLinearOperator":
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list, torch.Size)):
            sizes = tuple(sizes[0])
        reps = tuple(sizes[:-2])
        width = max(len(reps), len(self.batch_repeat))
        old = (1,) * (width - len(self.batch_repeat)) + self.batch_repeat
        new = (1,) * (width - len(reps)) + reps
        return BatchRepeatLinearOperator(self.base, batch_repeat=tuple(r * o for r, o in zip(new, old)))

    def _expand_batch(self, batch_shape):
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense().expand(*batch_shape, *self.matrix_shape))

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        # index b of a tiled dim is index b mod its size in the base; the
        # dims the base lacks are dropped (the indices arrive broadcast)
        _, bb = self._padded()
        nb = len(self.base.batch_shape)
        base_idx = [torch.as_tensor(b, device=row_index.device) % s for b, s in zip(batch_indices, bb)]
        return self.base._get_indices(row_index, col_index, *base_idx[len(bb) - nb :])
