"""Stochastic Lanczos quadrature (counterpart of
linear_operator_tpu/solvers/stochastic_lq.py).

tr(f(K)) ~= (n / m) sum_j sum_i (e1^T v_ij)^2 f(lambda_ij) over the Ritz
pairs of each of m unit-norm probes.  Identity-padded Ritz pairs carry zero
first components, so they get no weight; eigenvalues clamped to 0 are masked
out before ``f`` so that ``log`` never sees 0.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def slq_quadrature(
    matrix_size: int,
    evals: torch.Tensor,  # (nt, *b, k)
    evecs: torch.Tensor,  # (nt, *b, k, k)
    funcs: Sequence[Callable[[torch.Tensor], torch.Tensor]],
) -> list[torch.Tensor]:
    """[tr_est(f) for f in funcs], each of shape (*b,)."""
    valid = evals > 0
    weights = torch.where(valid, evecs[..., 0, :] ** 2, 0.0)  # (nt, *b, k)
    safe_evals = torch.where(valid, evals, 1.0)
    return [
        matrix_size * torch.sum(weights * f(safe_evals), dim=-1).mean(dim=0) for f in funcs
    ]
