"""Lazy sum of operators (counterpart of linear_operator_tpu/operators/sum.py)."""

from __future__ import annotations

import torch

from ..utils.broadcasting import broadcast_shapes
from ._linear_operator import LinearOperator, _iter_tensors


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

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """Term-wise: each term keeps its own backward (a kernel's blocked or
        fused one).  Tensors outside the terms (AddedDiag's
        ``precond_factor``, built on the detached operator) get None."""
        grads = []
        for name, value in vars(self).items():
            if name == "operators":
                for op in value:
                    grads.extend(op._bilinear_derivative(left_vecs, right_vecs))
            else:
                grads.extend(None for _ in _iter_tensors(value))
        return tuple(grads)

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

    def _expand_batch(self, batch_shape) -> "SumLinearOperator":
        return SumLinearOperator(tuple(op._expand_batch(batch_shape) for op in self.operators))

    def to_dense(self) -> torch.Tensor:
        out = self.operators[0].to_dense()
        for op in self.operators[1:]:
            out = out + op.to_dense()
        return out
