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
gradients, which ``inv_quad_logdet``'s and ``solve``'s backwards sum over
the model group.

What GSPMD runs of the unsharded operator runs here on the rank's rows:
* the preconditioner (``_preconditioner``, ``with_preconditioner``): the
  rank's rows of the unsharded factor L (Nystrom from global landmark
  indices with no collective; the strict pivoted Cholesky with a global
  argmax and the pivot's row of L from its owner a step) and the Woodbury
  closure on row blocks (one sum of (r, t) an application);
* ``solve``, through ``SolveLayout``'s reduction for a solve;
* the Cholesky route (``to_dense``, ``_solve_structure``): at n <=
  ``max_cholesky_size`` the unsharded operator forms K and factors it, so
  here the rows are gathered once and every rank factors the same n x n
  matrix, as GSPMD does.  That is the route's own n x n, not a fallback;
* the inverse root (``functions.root_inv_decomposition``): the rank's rows.

What the mesh does not cover raises NotImplementedError naming
``ROADMAP.md``: x's gradient, indexing, ``cat_rows``, a sum with anything
but a diagonal, the blocked pivoted Cholesky sweep, the forward root, the
inverse root's gradient and ``posterior_distribution``.  Nothing falls back
to a replicated or unpreconditioned solve.
"""

from __future__ import annotations

import torch

from .. import settings
from ..operators._linear_operator import LinearOperator
from . import _comm


def _queued(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of a row-sharded operator is not ported (ROADMAP.md queue 1, still to port under a mesh); "
        "a mesh with model=1 runs it on whole rows"
    )


class RowShardedLinearOperator(LinearOperator):
    """Rows R of K + D over a model group: ``rows`` is the (*b, |R|, n)
    block k(x_R, x) (a rectangular ``KernelLinearOperator``), ``diag`` a
    DiagLinearOperator of the whole n (``add_diagonal``) or None, ``sizes``
    the row counts of the group's ranks, ``row_group`` the model group
    (``_comm.Group``), ``mesh`` the mesh it was built on and
    ``precond_factor`` the rank's rows of a preconditioner factor
    (``with_preconditioner``) or None.  D is a constant diagonal (the
    noise), whose mat-vec takes any rows."""

    def __init__(self, rows: LinearOperator, diag, sizes: tuple, row_group: _comm.Group, mesh=None,
                 precond_factor: torch.Tensor | None = None):
        self.rows = rows
        self.diag = diag
        self.sizes = tuple(sizes)
        self.row_group = row_group
        self.mesh = mesh
        self.precond_factor = precond_factor

    @property
    def offset(self) -> int:
        """The global index of the rank's first row."""
        return sum(self.sizes[: self.row_group.index])

    def _shape(self) -> tuple[int, ...]:
        n = sum(self.sizes)
        return (*self.rows.batch_shape, n, n)

    def _transpose(self) -> "RowShardedLinearOperator":
        return self  # K + D is symmetric

    def _gather(self, v: torch.Tensor) -> torch.Tensor:
        return _comm.all_gather_rows(v, self.row_group, self.sizes)

    def row_slice(self) -> slice:
        """The rank's rows of a whole (*b, n, k) array."""
        return slice(self.offset, self.offset + self.rows.shape[-2])

    def _diag_rows(self) -> torch.Tensor:
        """D's entries on the rank's rows, (*b, |R|)."""
        return self.diag._diagonal()[..., self.row_slice()]

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
        R.  The preconditioner factor, built on the detached operator, gets
        None."""
        grads = list(self.rows._bilinear_derivative(left_vecs, self._gather(right_vecs)))
        if self.diag is not None:
            grads.extend(self.diag._bilinear_derivative(left_vecs, right_vecs))
        if self.precond_factor is not None:
            grads.append(None)
        return tuple(grads)

    # ---- the preconditioner ------------------------------------------------

    def _preconditioning_off(self) -> bool:
        """The unsharded AddedDiag's gate, on the whole n."""
        k = settings.max_preconditioner_size.value()
        return self.diag is None or k == 0 or self.shape[-1] < settings.min_preconditioning_size.value()

    def _build_precond_factor(self) -> torch.Tensor:
        """The rank's rows of the factor the unsharded operator builds under
        the current settings (``AddedDiagLinearOperator._build_precond_factor``)."""
        from ..operators.added_diag import auto_preconditioner_rank, nystrom_factor
        from ..solvers.pivoted_cholesky import pivoted_cholesky_with_pivots

        k = settings.max_preconditioner_size.value()
        mode = settings.preconditioner_mode.value()
        if mode in ("auto", "nystrom"):
            rank = auto_preconditioner_rank(self.shape[-1], k) if mode == "auto" else k
            return nystrom_factor(self.rows, rank=rank, whole=self._square())
        block = settings.pivoted_cholesky_block_size.value()
        if block and block > 1 and k > block:
            raise _queued("the blocked pivoted Cholesky sweep (settings.pivoted_cholesky_block_size)")
        diag = self.rows._replace(x2=self.rows.x1)._diagonal()  # K's diagonal on the rows R
        L, _ = pivoted_cholesky_with_pivots(self.rows, k, diag=diag, group=self.row_group, offset=self.offset)
        return L

    def _square(self) -> LinearOperator:
        """The whole k(x, x) on every rank, lazily: the Nystrom landmark
        block K[idx, idx] is taken from it, with no collective."""
        return self.rows._replace(x1=self.rows.x2, symmetric=True)

    def with_preconditioner(self, factor: torch.Tensor | None = None) -> "RowShardedLinearOperator":
        """The same operator carrying the rank's rows of the preconditioner
        factor, built once (``AddedDiagLinearOperator.with_preconditioner``);
        ``self`` where preconditioning is gated off or both solve and
        inv_quad_logdet take the Cholesky route."""
        if factor is None:
            n = self.shape[-1]
            if self._preconditioning_off():
                return self
            if settings.use_cholesky_for_solves(n) and settings.use_cholesky_for_log_prob(n):
                return self
            factor = self.detach()._build_precond_factor()
        return self._replace(precond_factor=factor)

    def _preconditioner(self):
        """(closure, precond_op, logdet_p) of the unsharded operator on the
        rank's rows: the closure applies P^{-1} to row blocks (one sum of
        (r, t) over the model group), ``precond_op`` holds the rows of L and
        D (its draws, ``zero_mean_mvn_samples(..., layout=)``, are the rank's
        rows of the unsharded ones) and log det P is whole.  None where the
        unsharded operator would take none."""
        from ..operators.dense import DenseLinearOperator
        from ..operators.low_rank_root_added_diag import woodbury_solve_closure
        from ..operators.root import LowRankRootLinearOperator

        if self._preconditioning_off():
            return None, None, None
        L = self.precond_factor
        if L is None:
            L = self._build_precond_factor()
        d = self._diag_rows()
        # a factor that went NaN on any rank degrades to P = D on every rank
        nan = _comm.any_flags(torch.isnan(L).any()[None], self.row_group, name="nan_check")
        if bool(nan[0]):
            from ..utils.warnings import debug_nan_check

            debug_nan_check("the preconditioner factor", L)
            L = torch.zeros_like(L)
        closure, logdet_p = woodbury_solve_closure(L, d, row_group=self.row_group)
        precond_op = LowRankRootLinearOperator(DenseLinearOperator(L)).add_diagonal(d)
        return closure, precond_op, logdet_p

    # ---- solves and the Cholesky route -------------------------------------

    def to_dense(self) -> torch.Tensor:
        """The whole K + D, (*b, n, n), the same on every rank: the rank's
        rows formed and gathered once over the model group.  Only the
        Cholesky route takes it, at n <= ``max_cholesky_size``, where the
        unsharded operator forms the same matrix: it is that route's own
        n x n, not a fallback.  Differentiable: each rank's rows carry its
        share of the parameters' gradients, which ``_comm.sum_grads`` sums
        over the model group, so every rank holds the whole gradient."""
        op = self._with_leaves(_comm.sum_grads(tuple(self._leaves()), self.row_group))
        block = op.rows.to_dense()
        if op.diag is not None:
            eye = torch.eye(block.shape[-1], dtype=block.dtype, device=block.device)[self.row_slice()]
            block = block + op._diag_rows()[..., None] * eye
        return _comm.gather_rows(block, self.row_group, self.sizes)

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor | None:
        """The Cholesky route of ``solve`` (n <= ``max_cholesky_size``): the
        rhs's rows gathered, the whole system solved on every rank, the
        rank's rows kept.  None above it (CG)."""
        if not settings.use_cholesky_for_solves(self.shape[-1]):
            return None
        whole = self._cholesky_impl(upper=False)._cholesky_solve(self._gather(rhs))
        return whole[..., self.row_slice(), :]

    def gather_rhs(self, rhs: torch.Tensor) -> torch.Tensor:
        """A rank's rows of a right-hand side, gathered whole and
        differentiably (the Cholesky route of ``inv_quad_logdet``)."""
        return _comm.gather_rows(rhs, self.row_group, self.sizes)

    def __add__(self, other):
        from ..operators.diag import DiagLinearOperator

        if isinstance(other, DiagLinearOperator):
            return self._replace(diag=other if self.diag is None else self.diag + other)
        raise _queued("a sum with anything but a diagonal")


def _queued_method(name: str):
    def method(self, *args, **kwargs):
        raise _queued(name)

    method.__name__ = name
    return method


for _name in (
    "root_decomposition", "diagonalization", "sqrt_inv_matmul", "zero_mean_mvn_samples", "_getitem",
    "_get_indices", "_select_rows", "_select_cols", "cat_rows", "add_low_rank", "mul", "_expand_batch",
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
    return RowShardedLinearOperator(rows, None, sizes, group, mesh)
