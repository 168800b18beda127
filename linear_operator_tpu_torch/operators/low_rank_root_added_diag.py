"""U U^T + D with exact O(n r^2) Woodbury solves (counterpart of
linear_operator_tpu/operators/low_rank_root_added_diag.py).

The cap matrix I + U^T D^{-1} U is Cholesky-factored once; solves and
log-determinants are then closed-form:

  (U U^T + D)^{-1} b = D^{-1} b - D^{-1} U (I + U^T D^{-1} U)^{-1} U^T D^{-1} b
  log det(U U^T + D) = log det(I + U^T D^{-1} U) + log det(D)

Nothing n x n is formed; the cost is the skinny (n x r) products.  They run
in full f32 (or f64), never TF32: as a CG preconditioner, a reduced-precision
P^{-1} stalls PCG at large n, and on the exact path it would cost the solve
its backward stability.
"""

from __future__ import annotations

import torch

from ..utils.cholesky import highest_matmul_precision
from ..utils.random import randn
from .added_diag import AddedDiagLinearOperator
from .diag import DiagLinearOperator
from .root import RootLinearOperator


def _build_cap_chol(U: torch.Tensor, dinv: torch.Tensor) -> torch.Tensor:
    """chol(I_r + U^T D^{-1} U), (*b, r, r): shared by
    ``woodbury_solve_closure`` and ``factorize``."""
    r = U.shape[-1]
    with highest_matmul_precision():
        cap = torch.eye(r, dtype=U.dtype, device=U.device) + torch.einsum(
            "...nr,...ns->...rs", dinv[..., :, None] * U, U
        )
    return torch.linalg.cholesky(cap)


def woodbury_solve_closure(U: torch.Tensor, diag: torch.Tensor, *, cap_chol: torch.Tensor | None = None):
    """(closure: v -> (U U^T + D)^{-1} v, logdet(U U^T + D)).

    U: (*b, n, r); diag: (*b, n).  D^{-1} is folded into the vector side
    (t = U^T (D^{-1} v), out = D^{-1} v - D^{-1} (U y)), so that applying the
    closure makes no scaled n x r copy of U.  ``cap_chol``, the cap matrix's
    Cholesky factor from ``LowRankRootAddedDiagLinearOperator.factorize``,
    skips its O(n r^2) build."""
    dinv = 1.0 / diag  # (*b, n)
    if cap_chol is None:
        cap_chol = _build_cap_chol(U, dinv)

    def closure(v: torch.Tensor) -> torch.Tensor:
        with highest_matmul_precision():
            dv = dinv[..., :, None] * v
            t = torch.einsum("...nr,...nt->...rt", U, dv)  # (*b, r, t)
            cap_b = cap_chol.expand(*t.shape[:-2], *cap_chol.shape[-2:])
            y = torch.cholesky_solve(t, cap_b, upper=False)
            return dv - dinv[..., :, None] * torch.matmul(U, y)

    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(cap_chol, dim1=-2, dim2=-1)), dim=-1
    ) + torch.sum(torch.log(diag), dim=-1)
    return closure, logdet


class LowRankRootAddedDiagLinearOperator(AddedDiagLinearOperator):
    """(LowRankRootLinearOperator, DiagLinearOperator) with exact Woodbury
    solves, log-determinants and samples; it is also the preconditioner's own
    operator.

    ``cap_chol`` optionally carries the cap matrix's Cholesky factor (see
    :meth:`factorize`), so that solve, logdet and inv_quad_logdet on the
    operator share one O(n r^2) factorization."""

    def __init__(
        self,
        root_op: RootLinearOperator,
        diag_op: DiagLinearOperator,
        *,
        cap_chol: torch.Tensor | None = None,
    ):
        if not isinstance(root_op, RootLinearOperator):
            raise TypeError("first operand must be a RootLinearOperator")
        super().__init__(root_op, diag_op)
        self.cap_chol = cap_chol

    @property
    def _root(self) -> torch.Tensor:
        return self.operators[0].root.to_dense()

    def with_preconditioner(self, factor=None):
        """No-op: the solves are exact, so a preconditioner factor would never
        be used.  :meth:`factorize` is the reuse this operator has."""
        return self

    def factorize(self) -> "LowRankRootAddedDiagLinearOperator":
        """The same operator carrying the cap matrix's Cholesky factor.

        The factor holds only for the tensors it was built from: after an
        update of U or D, factorize again (an operator built anew has none)."""
        dinv = 1.0 / self._diag_op._diagonal()
        return self._replace(cap_chol=_build_cap_chol(self._root, dinv))

    def _closure(self):
        return woodbury_solve_closure(self._root, self._diag_op._diagonal(), cap_chol=self.cap_chol)

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        closure, _ = self._closure()
        return closure(rhs)

    def _logdet_structure(self) -> torch.Tensor:
        """The matrix determinant lemma."""
        _, logdet = self._closure()
        return logdet

    def _inv_quad_logdet_structure(self, rhs, logdet: bool):
        """Exact and deterministic: no CG, no SLQ."""
        closure, ld = self._closure()
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        iq = zeros if rhs is None else torch.sum(closure(rhs) * rhs, dim=-2)
        return iq, ld if logdet else zeros

    def _preconditioner(self):
        return None, None, None

    def __add__(self, other):
        if isinstance(other, DiagLinearOperator):
            return LowRankRootAddedDiagLinearOperator(self.operators[0], self._diag_op + other)
        return super().__add__(other)

    def zero_mean_mvn_samples(
        self, num_samples: int, *, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Exact O(n r) N(0, U U^T + D) draws, U eps1 + sqrt(D) eps2, of shape
        (num_samples, *b, n); eps1 is (num_samples, *b, r) and eps2
        (num_samples, *b, n), the JAX package's shapes, both from
        ``generator`` (see ``utils.random.randn``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        U = self._root  # (*b, n, r)
        d = self._diag_op._diagonal()  # (*b, n)
        n, r = U.shape[-2], U.shape[-1]
        batch = self.batch_shape
        eps1 = randn((num_samples, *batch, r), self.dtype, self.device, generator)
        eps2 = randn((num_samples, *batch, n), self.dtype, self.device, generator)
        with highest_matmul_precision():
            low_rank = torch.matmul(U, eps1.movedim(0, -1)).movedim(-1, 0)  # (s, *b, n)
        return low_rank + torch.sqrt(d) * eps2
