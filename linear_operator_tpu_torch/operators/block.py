"""Block operators over a batched base whose dim -3 holds the blocks
(counterpart of linear_operator_tpu/operators/block.py): block-diagonal and
interleaved layouts.  Products, solves and Cholesky factors reshape the rhs
between (k n, t) and (k, n, t) and delegate to the base's batched ones;
log-determinants and quadratic forms sum over the blocks."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator


class BlockLinearOperator(LinearOperator):
    """Base of the block layouts (diagonal, interleaved, summed); the blocks
    are the base's dim -3."""


class BlockDiagLinearOperator(BlockLinearOperator):
    def __new__(cls, base=None):
        # a block diagonal of diagonal blocks is a diagonal operator
        from .diag import DiagLinearOperator

        if cls is BlockDiagLinearOperator and isinstance(base, DiagLinearOperator):
            diag = base._diagonal()  # (*b, k, n)
            return DiagLinearOperator(diag.reshape(*diag.shape[:-2], -1))
        return object.__new__(cls)

    def __init__(self, base: LinearOperator):
        self.base = base  # (*b, k, n, m)

    @property
    def num_blocks(self) -> int:
        return self.base.shape[-3]

    def _shape(self) -> tuple[int, ...]:
        s = self.base.shape
        return (*s[:-3], s[-3] * s[-2], s[-3] * s[-1])

    def _split(self, rhs: torch.Tensor, width: int) -> torch.Tensor:
        return rhs.reshape(*rhs.shape[:-2], self.num_blocks, width, rhs.shape[-1])

    def _split_rhs(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._split(rhs, self.base.shape[-1])

    def _join_out(self, out: torch.Tensor) -> torch.Tensor:
        return out.reshape(*out.shape[:-3], out.shape[-3] * out.shape[-2], out.shape[-1])

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._join_out(self.base._matmul(self._split_rhs(rhs)))

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._join_out(self.base._t_matmul(self._split(rhs, self.base.shape[-2])))

    def _transpose(self) -> "BlockDiagLinearOperator":
        return type(self)(self.base._transpose())

    def _diagonal(self) -> torch.Tensor:
        d = self.base._diagonal()  # (*b, k, n)
        return d.reshape(*d.shape[:-2], -1)

    def to_dense(self) -> torch.Tensor:
        dense = self.base.to_dense()  # (*b, k, n, m)
        k, n, m = dense.shape[-3:]
        eye = torch.eye(k, dtype=dense.dtype, device=dense.device)
        out = dense[..., :, None, :, :] * eye[:, :, None, None]  # (*b, k, k, n, m)
        return out.movedim(-3, -2).reshape(*dense.shape[:-3], k * n, k * m)

    def _solve_structure(self, rhs: torch.Tensor):
        from ..functions import solve

        return self._join_out(solve(self.base, self._split_rhs(rhs)))

    def _logdet_structure(self):
        from ..functions import inv_quad_logdet

        _, ld = inv_quad_logdet(self.base, None, logdet=True)
        return torch.sum(ld, dim=-1)

    def _inv_quad_logdet_structure(self, rhs, logdet):
        from ..functions import inv_quad_logdet

        split = None if rhs is None else self._split_rhs(rhs)
        iq, ld = inv_quad_logdet(self.base, split, logdet=logdet, reduce_inv_quad=False)
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        iq_out = zeros if rhs is None else torch.sum(iq, dim=-2)  # over blocks, keep columns
        return iq_out, torch.sum(ld, dim=-1) if logdet else zeros

    def _rewrap(self, base: LinearOperator) -> "BlockDiagLinearOperator":
        return type(self)(base)

    def _cholesky_impl(self, upper: bool = False):
        from .triangular import TriangularLinearOperator

        inner = self.base._cholesky_impl(upper=upper)
        base_tri = inner.tensor if isinstance(inner, TriangularLinearOperator) else inner
        if not isinstance(base_tri, LinearOperator):
            from .dense import DenseLinearOperator

            base_tri = DenseLinearOperator(base_tri)
        return TriangularLinearOperator(self._rewrap(base_tri), upper=upper)

    def _root_structure(self):
        r = self.base._root_structure()
        if r is None:
            r = self.base.root_decomposition().root
        return self._rewrap(r)

    def _root_inv_structure(self):
        r = self.base._root_inv_structure()
        if r is None:
            r = self.base.root_inv_decomposition().root
        return self._rewrap(r)

    def eigvalsh(self) -> torch.Tensor:
        ev = self.base.eigvalsh()  # (*b, k, n)
        return torch.sort(ev.reshape(*ev.shape[:-2], -1), dim=-1).values

    def _expand_batch(self, batch_shape):
        return self._rewrap(self.base._expand_batch((*batch_shape, self.num_blocks)))

    def _block_coords(self, row_index, col_index):
        n, m = self.base.shape[-2], self.base.shape[-1]
        return row_index // n, row_index % n, col_index // m, col_index % m

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        rb, ri, cb, ci = self._block_coords(row_index, col_index)
        base = self.base._expanded_to((*self.batch_shape, self.num_blocks))
        vals = base._get_indices(ri, ci, *batch_indices, rb)
        return torch.where(rb == cb, vals, torch.zeros_like(vals))


class BlockInterleavedLinearOperator(BlockDiagLinearOperator):
    """The same blocks with interleaved indices (the multitask layout): entry
    (i k + s, j k + s) comes from block s."""

    def _split(self, rhs: torch.Tensor, width: int) -> torch.Tensor:
        x = rhs.reshape(*rhs.shape[:-2], width, self.num_blocks, rhs.shape[-1])
        return x.transpose(-3, -2)  # (*b, k, width, t)

    def _join_out(self, out: torch.Tensor) -> torch.Tensor:
        x = out.transpose(-3, -2)  # (*b, n, k, t)
        return x.reshape(*x.shape[:-3], -1, x.shape[-1])

    def _diagonal(self) -> torch.Tensor:
        d = self.base._diagonal()  # (*b, k, n)
        return d.transpose(-1, -2).reshape(*d.shape[:-2], -1)

    def to_dense(self) -> torch.Tensor:
        dense = self.base.to_dense()  # (*b, k, n, m)
        k, n, m = dense.shape[-3:]
        eye = torch.eye(k, dtype=dense.dtype, device=dense.device)
        out = torch.einsum("...knm,ks->...nkms", dense, eye)
        return out.reshape(*dense.shape[:-3], n * k, m * k)

    def _block_coords(self, row_index, col_index):
        k = self.num_blocks
        return row_index % k, row_index // k, col_index % k, col_index // k
