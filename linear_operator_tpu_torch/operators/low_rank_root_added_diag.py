"""U U^T + D with exact O(n r^2) Woodbury solves (counterpart of
linear_operator_tpu/operators/low_rank_root_added_diag.py).

  (U U^T + D)^{-1} b = D^{-1} b - D^{-1} U (I + U^T D^{-1} U)^{-1} U^T D^{-1} b
  log det(U U^T + D) = log det(I + U^T D^{-1} U) + log det(D)
"""

from __future__ import annotations

import torch

from ..utils.cholesky import highest_matmul_precision
from .added_diag import AddedDiagLinearOperator
from .diag import DiagLinearOperator
from .root import RootLinearOperator


def woodbury_solve_closure(U: torch.Tensor, diag: torch.Tensor):
    """(closure: v -> (U U^T + D)^{-1} v, logdet(U U^T + D)).

    U: (*b, n, r); diag: (*b, n).  D^{-1} is folded into the vector side, so
    no scaled n x r copy of U is made.  Every product runs in full f32 (or
    f64), never TF32: a preconditioner applied at reduced precision stalls
    PCG at large n."""
    dinv = 1.0 / diag  # (*b, n)
    r = U.shape[-1]
    with highest_matmul_precision():
        cap = torch.eye(r, dtype=U.dtype, device=U.device) + torch.einsum(
            "...nr,...ns->...rs", dinv[..., :, None] * U, U
        )
    cap_chol = torch.linalg.cholesky(cap)

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
    """(LowRankRootLinearOperator, DiagLinearOperator): exact Woodbury
    solves; it is the preconditioner's own operator and draws its probes."""

    def __init__(self, root_op: RootLinearOperator, diag_op: DiagLinearOperator):
        if not isinstance(root_op, RootLinearOperator):
            raise TypeError("first operand must be a RootLinearOperator")
        super().__init__(root_op, diag_op)

    @property
    def _root(self) -> torch.Tensor:
        return self.operators[0].root.to_dense()

    def _preconditioner(self):
        return None, None, None

    def zero_mean_mvn_samples(
        self, num_samples: int, *, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Exact O(n r) N(0, U U^T + D) draws, U eps1 + sqrt(D) eps2, of shape
        (num_samples, *b, n).  The normals are drawn on the generator's own
        device, so one seed gives the same probes on the CPU and the card."""
        U = self._root  # (*b, n, r)
        d = self._diag_op._diagonal()  # (*b, n)
        n, r = U.shape[-2], U.shape[-1]
        batch = self.batch_shape
        draw_device = generator.device if generator is not None else self.device

        def normal(*shape):
            z = torch.randn(shape, dtype=self.dtype, device=draw_device, generator=generator)
            return z.to(self.device)

        eps1 = normal(*batch, r, num_samples)
        eps2 = normal(num_samples, *batch, n)
        with highest_matmul_precision():
            low_rank = torch.matmul(U, eps1).movedim(-1, 0)  # (s, *b, n)
        return low_rank + torch.sqrt(d) * eps2
