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


class StochasticLQ:
    """The object-style SLQ workflow of GPyTorch's ``StochasticLQ``, on
    :func:`lanczos_tridiag` and :func:`slq_quadrature`:
    ``lanczos_batch(matmul_closure, rhs_vectors)``, then ``to_dense(
    matrix_shape, evals, evecs, funcs)``."""

    def __init__(self, max_iter: int = 15, num_random_probes: int = 10):
        self.max_iter = max_iter
        self.num_random_probes = num_random_probes

    def lanczos_batch(self, matmul_closure, rhs_vectors: torch.Tensor):
        """``rhs_vectors`` (*b, n, p) -> (Q (p, *b, n, k), T (p, *b, k, k)):
        the probes move to a leading dim, over which ``matmul_closure``
        (an operator's ``matmul``) broadcasts."""
        from .lanczos import lanczos_tridiag

        res = lanczos_tridiag(matmul_closure, self.max_iter, init_vecs=torch.movedim(rhs_vectors, -1, 0))
        return res.q_mat, res.t_mat

    def to_dense(self, matrix_shape, eigenvalues, eigenvectors, funcs) -> list[torch.Tensor]:
        """tr(f(A)) estimates from the probes' Ritz pairs."""
        return slq_quadrature(matrix_shape[-1], eigenvalues, eigenvectors, funcs)
