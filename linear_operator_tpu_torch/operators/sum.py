"""Lazy sum of operators (counterpart of linear_operator_tpu/operators/sum.py)."""

from __future__ import annotations

import torch

from ..utils.broadcasting import broadcast_shapes
from ._linear_operator import LinearOperator


class SumLinearOperator(LinearOperator):
    def __init__(self, operators: tuple):
        if len(operators) < 1:
            raise ValueError("SumLinearOperator needs at least one term")
        self.operators = tuple(operators)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        out = self.operators[0]._matmul(rhs)
        for op in self.operators[1:]:
            out = out + op._matmul(rhs)
        return out

    def _matmul_closure(self):
        # Compose the terms' closures so per-solve setup (a kernel's dense
        # cache) survives wrapping in K + noise * I.
        closures = [op._matmul_closure() for op in self.operators]

        def mm(rhs: torch.Tensor) -> torch.Tensor:
            out = closures[0](rhs)
            for c in closures[1:]:
                out = out + c(rhs)
            return out

        return mm

    def _shape(self) -> tuple[int, ...]:
        batch = broadcast_shapes(*(op.batch_shape for op in self.operators))
        matrix = broadcast_shapes(*(op.matrix_shape for op in self.operators))
        return (*batch, *matrix)

    def _transpose(self) -> "SumLinearOperator":
        return SumLinearOperator(tuple(op._transpose() for op in self.operators))

    def _diagonal(self) -> torch.Tensor:
        out = self.operators[0]._diagonal()
        for op in self.operators[1:]:
            out = out + op._diagonal()
        return out

    def to_dense(self) -> torch.Tensor:
        out = self.operators[0].to_dense()
        for op in self.operators[1:]:
            out = out + op.to_dense()
        return out
