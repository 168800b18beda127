"""Lazy sum over a batch dim (counterpart of
linear_operator_tpu/operators/sum_batch.py): the base carries an extra batch
dim at -3, summed out in every product."""

from __future__ import annotations

import torch

from ._linear_operator import LinearOperator
from .block import BlockLinearOperator


class SumBatchLinearOperator(BlockLinearOperator):
    def __init__(self, base: LinearOperator, block_dim: int = -3):
        if block_dim != -3:
            raise ValueError("block_dim must be -3 (permute batch dims first)")
        self.base = base
        self.block_dim = block_dim

    def _shape(self) -> tuple[int, ...]:
        s = self.base.shape
        return (*s[:-3], *s[-2:])

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.base._matmul(rhs.unsqueeze(-3)), dim=-3)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.base._t_matmul(rhs.unsqueeze(-3)), dim=-3)

    def _transpose(self) -> "SumBatchLinearOperator":
        return SumBatchLinearOperator(self.base._transpose())

    def _diagonal(self) -> torch.Tensor:
        return torch.sum(self.base._diagonal(), dim=-2)

    def to_dense(self) -> torch.Tensor:
        return torch.sum(self.base.to_dense(), dim=-3)

    def _expand_batch(self, batch_shape) -> "SumBatchLinearOperator":
        return SumBatchLinearOperator(self.base._expand_batch((*batch_shape, self.base.shape[-3])))

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        k = self.base.shape[-3]
        blocks = torch.arange(k, device=row_index.device)
        base = self.base._expanded_to((*self.batch_shape, k))
        vals = base._get_indices(row_index[..., None], col_index[..., None], *[b[..., None] for b in batch_indices], blocks)
        return torch.sum(vals, dim=-1)
