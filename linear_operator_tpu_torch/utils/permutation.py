"""Permutation helpers (counterpart of linear_operator_tpu/utils/permutation.py)."""

from __future__ import annotations

import torch


def apply_permutation(matrix, left_permutation: torch.Tensor | None = None, right_permutation: torch.Tensor | None = None):
    """P_left M P_right^T by row and column gathers; the left permutation may
    be partial (fewer rows out than in).  ``matrix`` is an operator or a
    tensor."""
    from ..operators._linear_operator import LinearOperator

    dense = matrix.to_dense() if isinstance(matrix, LinearOperator) else torch.as_tensor(matrix)
    if left_permutation is not None:
        idx = left_permutation[..., :, None].expand(*dense.shape[:-2], left_permutation.shape[-1], dense.shape[-1])
        dense = torch.gather(dense, -2, idx)
    if right_permutation is not None:
        idx = right_permutation[..., None, :].expand(*dense.shape[:-1], right_permutation.shape[-1])
        dense = torch.gather(dense, -1, idx)
    return dense


def inverse_permutation(permutation: torch.Tensor) -> torch.Tensor:
    """The argsort of a permutation is its inverse."""
    return torch.argsort(permutation, dim=-1)
