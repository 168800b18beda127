"""The row-sharded GP operator of the ``model`` axis: the port's counterpart
of what GSPMD makes of ``KernelLinearOperator`` under ``P("data", "model",
None)`` (counterpart of linear_operator_tpu/parallel/sharding.py's layout).

Each rank of a model group holds rows R of x; x is gathered once, when the
operator is built.  The operator is K + D restricted to the rank's rows, and
it maps a vector's rows R to the product's rows R: a mat-vec gathers the
vector over the model group and computes k(x_R, x) v (K1 on the card, as
``KernelLinearOperator`` computes any rectangular block), plus D's rows R.
Its ``shape`` is the whole (*b, n, n), so that ``inv_quad_logdet`` draws
whole probes and SLQ scales by n; the tensors it takes and returns are the
rank's rows.  ``_bilinear_derivative`` takes the rank's rows of the left
vectors and gathers the right ones, and returns this rank's share of the
gradients, which ``inv_quad_logdet``'s backward sums over the model group.

What the mesh does not cover yet raises NotImplementedError naming
``ROADMAP.md``: a preconditioner, the Cholesky path, solves outside
``inv_quad_logdet``, roots, dense forms and indexing.  Nothing falls back to
a replicated or unpreconditioned solve.
"""

from __future__ import annotations

import torch

from ..operators._linear_operator import LinearOperator
from . import _comm


def _queued(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of a row-sharded operator is not ported (ROADMAP.md queue 1: the posterior, solve, LOVE and "
        "the preconditioner under a mesh); a mesh with model=1 runs it on whole rows"
    )


class RowShardedLinearOperator(LinearOperator):
    """Rows R of K + D over a model group: ``rows`` is the (*b, |R|, n)
    block k(x_R, x) (a rectangular ``KernelLinearOperator``), ``diag`` a
    constant DiagLinearOperator (``add_diagonal``) or None, ``sizes`` the
    row counts of the group's ranks, ``row_group`` the model group
    (``_comm.Group``)."""

    def __init__(self, rows: LinearOperator, diag, sizes: tuple, row_group: _comm.Group):
        self.rows = rows
        self.diag = diag
        self.sizes = tuple(sizes)
        self.row_group = row_group

    def _shape(self) -> tuple[int, ...]:
        n = sum(self.sizes)
        return (*self.rows.batch_shape, n, n)

    def _transpose(self) -> "RowShardedLinearOperator":
        return self  # K + D is symmetric

    def _gather(self, v: torch.Tensor) -> torch.Tensor:
        return _comm.all_gather_rows(v, self.row_group, self.sizes)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        out = self.rows._matmul(self._gather(rhs))
        return out if self.diag is None else out + self.diag._matmul(rhs)

    def _matmul_closure(self):
        rows = self.rows._matmul_closure()

        def mm(rhs: torch.Tensor) -> torch.Tensor:
            out = rows(self._gather(rhs))
            return out if self.diag is None else out + self.diag._matmul(rhs)

        return mm

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """This rank's share: the rows' backward on the gathered right
        vectors (K1 and two K2 launches on the card), and D's on the rows
        R."""
        grads = list(self.rows._bilinear_derivative(left_vecs, self._gather(right_vecs)))
        if self.diag is not None:
            grads.extend(self.diag._bilinear_derivative(left_vecs, right_vecs))
        return tuple(grads)

    def _preconditioner(self):
        """None where the unsharded K + D would take none (the same gate on
        the whole n: ``max_preconditioner_size`` 0 or n below
        ``min_preconditioning_size``); raises where it would take one."""
        from .. import settings

        k = settings.max_preconditioner_size.value()
        if self.diag is None or k == 0 or self.shape[-1] < settings.min_preconditioning_size.value():
            return None, None, None
        raise _queued("a preconditioner")

    def _solve_via_cg(self, rhs, preconditioner=None, n_tridiag: int = 0, reduction=None):
        if reduction is None:
            raise _queued("a solve outside inv_quad_logdet")
        return super()._solve_via_cg(rhs, preconditioner=preconditioner, n_tridiag=n_tridiag, reduction=reduction)

    def __add__(self, other):
        from ..operators.diag import DiagLinearOperator

        if isinstance(other, DiagLinearOperator):
            return self._replace(diag=other if self.diag is None else self.diag + other)
        raise _queued("a sum")


def _queued_method(name: str):
    def method(self, *args, **kwargs):
        raise _queued(name)

    method.__name__ = name
    return method


for _name in (
    "to_dense", "_cholesky_impl", "root_decomposition", "root_inv_decomposition", "diagonalization",
    "sqrt_inv_matmul", "zero_mean_mvn_samples", "_getitem", "_get_indices", "_select_rows", "_select_cols",
    "cat_rows", "add_low_rank", "mul", "_expand_batch", "with_preconditioner", "solve",
):
    setattr(RowShardedLinearOperator, _name, _queued_method(_name))


def row_sharded_kernel_operator(x, params: dict, mesh, **kernel_kwargs) -> RowShardedLinearOperator:
    """The rank's rows of the kernel operator k(x, x) on ``mesh``'s model
    axis, from the rank's rows ``x`` (*b, |R|, d): x is gathered over the
    model group (the row counts exchanged first, so that they may be
    uneven), and the rows are a rectangular ``KernelLinearOperator`` on
    (x_R, x) with ``kernel_kwargs``.  x may not require a gradient: its
    columns' share would have to come back to their ranks (not ported)."""
    from ..operators.kernel import KernelLinearOperator

    if x.requires_grad:
        raise _queued("a gradient in x")
    group = mesh.group("model")
    counts = torch.zeros(mesh.size("model"), dtype=torch.float64, device=x.device)
    counts[mesh.index("model")] = x.shape[-2]
    sizes = tuple(int(c) for c in _comm.all_reduce(counts, group).tolist())
    x_all = _comm.all_gather_rows(x, group, sizes)
    rows = KernelLinearOperator(x, x_all, params, symmetric=False, **kernel_kwargs)
    return RowShardedLinearOperator(rows, None, sizes, group)
