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

    def __add__(self, other):
        from .added_diag import AddedDiagLinearOperator
        from .dense import DenseLinearOperator
        from .diag import DiagLinearOperator
        from .zero import ZeroLinearOperator

        if isinstance(other, ZeroLinearOperator):
            return self
        if isinstance(other, DiagLinearOperator):
            return AddedDiagLinearOperator(self, other)
        if isinstance(other, SumLinearOperator):
            return SumLinearOperator((*self.operators, *other.operators))
        if isinstance(other, LinearOperator):
            return SumLinearOperator((*self.operators, other))
        other = torch.as_tensor(other, dtype=self.dtype, device=self.device)
        if other.ndim == 0:
            return super().__add__(other)
        return SumLinearOperator((*self.operators, DenseLinearOperator(other)))

    def _batch_expanded_terms(self) -> tuple:
        """The terms expanded to the sum's batch shape: a term with fewer or
        singleton batch dims cannot take the sum's batch indices."""
        return tuple(op._expanded_to(self.batch_shape) for op in self.operators)

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        return SumLinearOperator(
            tuple(op._getitem(row_index, col_index, *batch_indices) for op in self._batch_expanded_terms())
        )

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        terms = self._batch_expanded_terms()
        out = terms[0]._get_indices(row_index, col_index, *batch_indices)
        for op in terms[1:]:
            out = out + op._get_indices(row_index, col_index, *batch_indices)
        return out

    def to_dense(self) -> torch.Tensor:
        out = self.operators[0].to_dense()
        for op in self.operators[1:]:
            out = out + op.to_dense()
        return out


class PsdSumLinearOperator(SumLinearOperator):
    """A sum of positive semi-definite terms, sampled by summing the terms'
    own samples: each term draws from ``generator`` in turn (a fixed CPU
    generator when None), so that every term keeps its structured sampler."""

    def zero_mean_mvn_samples(self, num_samples: int, *, generator: torch.Generator | None = None) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        out = None
        for op in self.operators:
            s = op.zero_mean_mvn_samples(num_samples, generator=generator)
            out = s if out is None else out + s
        return out
