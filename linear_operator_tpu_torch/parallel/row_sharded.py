"""The row-sharded GP operator of the ``model`` axis: the port's counterpart
of what GSPMD makes of ``KernelLinearOperator`` under ``P("data", "model",
None)`` (linear_operator_tpu/parallel/sharding.py's layout) and of the SKI
interpolation row-sharded by ``_maybe_shard_blocks``
(linear_operator_tpu/utils/grid_interp.py).

Each rank of a model group holds rows R of the points.  The operator is
K + D restricted to the rank's rows, and it maps a vector's rows R to the
product's rows R.  Its ``rows`` form that product, in one of two ways:

* :class:`KernelRows`, k(x_R, x): x is gathered once, when the operator is
  built, and a mat-vec gathers the vector over the model group and computes
  k(x_R, x) v (K1 on the card, as ``KernelLinearOperator`` computes any
  rectangular block);
* :class:`InterpolatedRows`, W_R K_grid W^T (SKI): a mat-vec sums
  u = sum_ranks W_R^T v_R, (M, t), over the model group in one all-reduce
  ("interp") and forms W_R (K_grid u) locally on the replicated grid.  No
  (n, t) vector is gathered.

D's rows are added to either.  Its ``shape`` is the whole (*b, n, n), so
that ``inv_quad_logdet`` draws whole probes and SLQ scales by n; the tensors
it takes and returns are the rank's rows.  ``_bilinear_derivative`` takes
the rank's rows of both vectors and returns this rank's share of the
gradients.  The operator's tensors are of two kinds (``own_leaves``): the
rank's own rows (x_R, W_R's stencils), whose gradient is the rank's alone,
and replicated ones (the hyperparameters, the gathered x), whose shares
``inv_quad_logdet``'s and ``solve``'s backwards sum over the model group
(``SolveLayout.reduce_grads``).  So x may require a gradient: the gathered
x's whole-n gradient is summed once, and ``_comm.gather_rows``'s backward
hands each rank its rows of it, beside its own rows' gradient, which is the
reduce-scatter GSPMD inserts.

What GSPMD runs of the unsharded operator runs here on the rank's rows, for
both kinds of rows, through one code path:
* the preconditioner (``_preconditioner``, ``with_preconditioner``): the
  rank's rows of the unsharded factor L (Nystrom from global landmark
  indices, whose points or stencils the rows fetch once; the strict
  pivoted Cholesky with a global argmax, the pivot's point or stencil and
  its row of L from its owner a step; the blocked sweep with the global top
  2 bs of the residual diagonal, the pool's rows of L and stencils from
  their owners a sweep, ``pool``) and the Woodbury closure on row blocks
  (one sum of (r, t) an application);
* ``solve``, through ``SolveLayout``'s reduction for a solve;
* the Cholesky route (``to_dense``, ``_solve_structure``): at n <=
  ``max_cholesky_size`` the unsharded operator forms K and factors it, so
  here the rows are formed (SKI's stencils gathered once), gathered once,
  and every rank factors the same n x n matrix, as GSPMD does.  That is the
  route's own n x n, not a fallback;
* Lanczos and the roots (``functions/_root_decomposition.py``): the rank's
  rows of the root, the inverse root and ``diagonalization``'s vectors
  (the eigenvalues whole), their gradients (shares summed once), and
  ``zero_mean_mvn_samples``, the rank's rows of the unsharded draw;
* a gradient in SKI's interpolation weights: W_R's own, from K_grid W^T
  right (the forward's sum) and K_grid W^T left (a second sum,
  "interp_left").

What the mesh does not cover raises NotImplementedError naming
``ROADMAP.md``: indexing, ``cat_rows``, a sum with anything but a
diagonal, ``add_low_rank``, ``mul``, a batch expansion, and
``sqrt_inv_matmul`` with CIQ draws.  Nothing falls back to a replicated
or unpreconditioned solve.
"""

from __future__ import annotations

import torch

from .. import settings
from ..operators._linear_operator import LinearOperator
from ..operators.interpolated import (
    InterpolatedLinearOperator,
    InterpolationMatrix,
    _batch_aranges,
    _interp_to_dense,
)
from ..functions._solve import _unbroadcast
from ..utils.sparse import left_interp, left_t_interp
from . import _comm


def _queued(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of a row-sharded operator is not ported (ROADMAP.md queue 1, still to port under a mesh); "
        "a mesh with model=1 runs it on whole rows"
    )


class KernelRows(LinearOperator):
    """The rank's rows k(x_R, x) of a kernel operator, (*b, |R|, n): its
    products take and return the rank's rows, gathering the vector over
    ``group`` (``sizes`` the group's row counts).  ``kernel`` is a
    rectangular ``KernelLinearOperator`` on (x_R, x); x_R is the rank's own,
    x gathered."""

    def __init__(self, kernel: LinearOperator, sizes: tuple, group: _comm.Group):
        self.kernel = kernel
        self.sizes = tuple(sizes)
        self.group = group

    def _shape(self) -> tuple[int, ...]:
        return self.kernel.shape

    def _gather(self, v: torch.Tensor) -> torch.Tensor:
        return _comm.all_gather_rows(v, self.group, self.sizes)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.kernel._matmul(self._gather(rhs))

    def _matmul_closure(self):
        mm = self.kernel._matmul_closure()
        return lambda rhs: mm(self._gather(rhs))

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """The kernel's backward on the gathered right vectors (K1 and two
        K2 launches on the card: x_R's gradient and the gathered x's)."""
        return self.kernel._bilinear_derivative(left_vecs, self._gather(right_vecs))

    def owned(self) -> tuple:
        return (self.kernel.x1,)

    def row_diagonal(self) -> torch.Tensor:
        """K's diagonal on the rank's rows, (*b, |R|)."""
        return self.kernel._replace(x2=self.kernel.x1)._diagonal()

    def pivot_column(self, pivot: torch.Tensor) -> torch.Tensor:
        """K's column ``pivot`` (global, (*b,)) on the rank's rows: k(x_R,
        x_pivot), pointwise."""
        batch, n = tuple(pivot.shape), self.shape[-2]
        row = torch.arange(n, device=pivot.device).expand(*batch, n)
        return self.kernel._get_indices(row, pivot[..., None].expand(*batch, n),
                                        *_batch_aranges(batch, (n,), pivot.device))

    def landmarks(self, idx: torch.Tensor) -> tuple:
        """(K[R, idx], K[idx, idx]) for global landmark indices ``idx``: the
        landmark points are in the gathered x, so no collective."""
        eye = torch.eye(len(idx), dtype=self.dtype, device=self.device)
        whole = self.kernel._replace(x1=self.kernel.x2, symmetric=True)
        return (self.kernel._select_cols(idx)._matmul(eye),
                whole._select_rows(idx)._select_cols(idx)._matmul(eye))

    def pool(self, idx: torch.Tensor, extra: torch.Tensor) -> tuple:
        """(K[R, idx], K[idx, idx], extra's rows idx) for global indices
        ``idx`` (j,) of an unbatched operator (a blocked pivoted sweep's
        pool): the points are in the gathered x, ``extra`` (|R|, e) comes
        from the rows' owners in one collective ("pool")."""
        j, rows = len(idx), self.shape[-2]
        whole = self.kernel._replace(x1=self.kernel.x2, symmetric=True)
        own = torch.arange(rows, device=idx.device)
        return (self.kernel._get_indices(own[:, None].expand(rows, j), idx[None, :].expand(rows, j)),
                whole._get_indices(idx[:, None].expand(j, j), idx[None, :].expand(j, j)),
                _comm.owner_rows(extra, idx, self.group, sum(self.sizes[: self.group.index]), name="pool"))

    def block(self) -> torch.Tensor:
        """The dense (*b, |R|, n) rows."""
        return self.kernel.to_dense()


class InterpolatedRows(LinearOperator):
    """The rank's rows W_R K_grid W^T of an interpolated operator (SKI),
    (*b, |R|, n): ``base`` the grid operator K_grid (M, M), replicated on
    every rank, and ``indices`` and ``values`` (*b, |R|, k) the flat
    stencils of the rank's own points.  A product takes the rank's rows v_R
    and returns its rows: u = sum over ``group`` of W_R^T v_R ((M, t), one
    all-reduce, "interp"), then W_R (K_grid u), local
    (``_maybe_shard_blocks``' layout: one psum for W^T v, W g local)."""

    def __init__(self, base: LinearOperator, indices: torch.Tensor, values: torch.Tensor, sizes: tuple,
                 group: _comm.Group):
        self.base = base
        self.indices = indices
        self.values = values
        self.sizes = tuple(sizes)
        self.group = group

    def _shape(self) -> tuple[int, ...]:
        batch = torch.broadcast_shapes(tuple(self.base.batch_shape), tuple(self.indices.shape[:-2]))
        return (*batch, self.indices.shape[-2], sum(self.sizes))

    @property
    def grid_size(self) -> int:
        return self.base.shape[-1]

    def _interp_sum(self, rhs: torch.Tensor) -> torch.Tensor:
        """W^T v = sum over the group of W_R^T v_R, (*b, M, t)."""
        return _comm.all_reduce(left_t_interp(self.indices, self.values, rhs, self.grid_size), self.group,
                                name="interp")

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return left_interp(self.indices, self.values, self.base._matmul(self._interp_sum(rhs)))

    def _matmul_closure(self):
        mm = self.base._matmul_closure()
        return lambda rhs: left_interp(self.indices, self.values, mm(self._interp_sum(rhs)))

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """This rank's share: the grid operator's backward on (W_R^T left_R,
        W^T right), the right side summed over the group.  The weights W_R
        (``values``, the rank's own) get their whole gradient, sum(left_R
        (K_grid W^T right)[stencil] + right_R (K_grid W^T left)[stencil])
        over the columns, from a second sum ("interp_left") of W_R^T left_R;
        the indices get None."""
        u = self._interp_sum(right_vecs)
        a = left_t_interp(self.indices, self.values, left_vecs, self.grid_size)
        grads = self.base._bilinear_derivative(a, u)
        if not self.values.requires_grad:
            return (*grads, None, None)
        a_all = _comm.all_reduce(a, self.group, name="interp_left")
        g = (left_vecs[..., None, :] * _at_stencils(self.indices, self.base._matmul(u))
             + right_vecs[..., None, :] * _at_stencils(self.indices, self.base._matmul(a_all))).sum(dim=-1)
        return (*grads, None, _unbroadcast(g, self.values.shape))

    def owned(self) -> tuple:
        return (self.indices, self.values)

    def row_diagonal(self) -> torch.Tensor:
        """K's diagonal on the rank's rows, (*b, |R|)."""
        return InterpolatedLinearOperator(self.base, self.indices, self.values, self.indices, self.values)._diagonal()

    def _stencils(self, index: torch.Tensor, name: str, extra: torch.Tensor | None = None) -> tuple:
        """The stencils (indices, values) of the global rows ``index``
        ((*b, j) or (j,)), (*b, j, k) each, and ``extra``'s rows (*b, j, e)
        (or an empty tail), from their owners in one collective."""
        k = self.indices.shape[-1]
        offset = sum(self.sizes[: self.group.index])
        parts = [self.indices.to(self.values.dtype), self.values]
        table = torch.cat(parts if extra is None else [*parts, extra.to(self.values.dtype)], dim=-1)
        got = _comm.owner_rows(table, index, self.group, offset, name=name)
        return got[..., :k].round().to(self.indices.dtype), got[..., k : 2 * k], got[..., 2 * k :]

    def pivot_column(self, pivot: torch.Tensor) -> torch.Tensor:
        """K's column ``pivot`` (global, (*b,)) on the rank's rows: W_R
        K_grid w_p^T, the pivot's stencil w_p from its owner."""
        idx, val, _ = self._stencils(pivot[..., None], "owner_row")  # (*b, 1, k)
        ones = torch.ones((*idx.shape[:-1], 1), dtype=val.dtype, device=val.device)
        grid = left_t_interp(idx, val, ones, self.grid_size)  # (*b, M, 1)
        return left_interp(self.indices, self.values, self.base._matmul(grid))[..., 0]

    def landmarks(self, idx: torch.Tensor) -> tuple:
        """(K[R, idx], K[idx, idx]) for global landmark indices ``idx``: the
        landmarks' stencils fetched from their owners once ("landmarks"),
        then W_R K_grid W_idx^T and W_idx K_grid W_idx^T from one product of
        the grid operator."""
        li, lv, _ = self._stencils(idx, "landmarks")  # (*b, k, s)
        return self._columns(li, lv)

    def _columns(self, li: torch.Tensor, lv: torch.Tensor) -> tuple:
        """(K[R, idx], K[idx, idx]) from the stencils of the points idx: W_R
        K_grid W_idx^T and W_idx K_grid W_idx^T from one product of the grid
        operator."""
        eye = torch.eye(li.shape[-2], dtype=self.dtype, device=self.device)
        kw = self.base._matmul(left_t_interp(li, lv, eye, self.grid_size))  # (*b, M, j)
        return left_interp(self.indices, self.values, kw), left_interp(li, lv, kw)

    def pool(self, idx: torch.Tensor, extra: torch.Tensor) -> tuple:
        """(K[R, idx], K[idx, idx], extra's rows idx) for global indices
        ``idx`` (j,) (a blocked pivoted sweep's pool): the points' stencils
        and ``extra``'s rows (|R|, e) from their owners in one collective
        ("pool")."""
        li, lv, rows = self._stencils(idx, "pool", extra)
        return (*self._columns(li, lv), rows)

    def block(self) -> torch.Tensor:
        """The dense (*b, |R|, n) rows W_R K_grid W^T, every rank's stencils
        gathered once (the Cholesky route's n is small).  The gathered
        weights are used for the rank's rows alone: their gradient is summed
        over the group before each rank keeps its own rows'."""
        whole_idx = _comm.all_gather_rows(self.indices.to(torch.float64), self.group, self.sizes)
        (whole_val,) = _comm.sum_grads((_comm.gather_rows(self.values, self.group, self.sizes),), self.group)
        w = InterpolationMatrix(whole_idx.round().to(self.indices.dtype), whole_val, self.grid_size)
        return left_interp(self.indices, self.values, self.base._matmul(_interp_to_dense(w).mT))


def _at_stencils(indices: torch.Tensor, grid_vecs: torch.Tensor) -> torch.Tensor:
    """Grid vectors (*b, M, t) at each row's stencil points, (*b, rows, k, t)."""
    batch = torch.broadcast_shapes(tuple(indices.shape[:-2]), tuple(grid_vecs.shape[:-2]))
    rows, k = indices.shape[-2:]
    flat = indices.expand(*batch, rows, k).reshape(*batch, rows * k, 1)
    got = torch.take_along_dim(grid_vecs.expand(*batch, *grid_vecs.shape[-2:]), flat, dim=-2)
    return got.reshape(*batch, rows, k, grid_vecs.shape[-1])


class RowShardedLinearOperator(LinearOperator):
    """Rows R of K + D over a model group: ``rows`` the rank's rows of K
    (a :class:`KernelRows` or an :class:`InterpolatedRows`, whose products
    take and return the rank's rows), ``diag`` a DiagLinearOperator of the
    whole n (``add_diagonal``) or None, ``mesh`` the mesh it was built on
    and ``precond_factor`` the rank's rows of a preconditioner factor
    (``with_preconditioner``) or None.  D is a constant diagonal (the
    noise), whose mat-vec takes any rows."""

    def __init__(self, rows: LinearOperator, diag, mesh=None, precond_factor: torch.Tensor | None = None):
        self.rows = rows
        self.diag = diag
        self.mesh = mesh
        self.precond_factor = precond_factor

    @property
    def sizes(self) -> tuple:
        """The row counts of the model group's ranks."""
        return self.rows.sizes

    @property
    def row_group(self) -> _comm.Group:
        """The model group (``_comm.Group``)."""
        return self.rows.group

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

    def own_leaves(self) -> list:
        """For each of ``_leaves()``, whether it is the rank's own rows
        (x_R, W_R's stencils), whose gradient is never summed over the
        model group; the rest are replicated, their gradients shares."""
        owned = self.rows.owned()
        return [any(t is o for o in owned) for t in self._leaves()]

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        out = self.rows._matmul(rhs)
        return out if self.diag is None else out + self.diag._matmul(rhs)

    def _matmul_closure(self):
        rows = self.rows._matmul_closure()

        def mm(rhs: torch.Tensor) -> torch.Tensor:
            out = rows(rhs)
            return out if self.diag is None else out + self.diag._matmul(rhs)

        return mm

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """This rank's share: the rows' backward on the rank's rows of both
        vectors, and D's on the rows R.  The preconditioner factor, built on
        the detached operator, gets None."""
        grads = list(self.rows._bilinear_derivative(left_vecs, right_vecs))
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

        k = settings.max_preconditioner_size.value()
        mode = settings.preconditioner_mode.value()
        if mode in ("auto", "nystrom"):
            rank = auto_preconditioner_rank(self.shape[-1], k) if mode == "auto" else k
            return nystrom_factor(self.rows, rank=rank, landmarks=self.rows.landmarks)
        return self.pivoted_factor(k)[0]

    def pivoted_factor(self, rank: int, block_size: int | None = None) -> tuple:
        """(the rank's rows of K's pivoted Cholesky factor, the pivots), as
        ``solvers.pivoted_cholesky`` builds them unsharded: the blocked sweep
        where ``block_size`` (default ``settings.pivoted_cholesky_block_size``)
        is above 1 and below ``rank``, forward-only, else the strict greedy."""
        from ..solvers.pivoted_cholesky import (
            _forward_only,
            blocked_pivoted_cholesky_with_pivots,
            pivoted_cholesky_with_pivots,
        )

        if block_size is None:
            block_size = settings.pivoted_cholesky_block_size.value()
        rows = dict(diag=self.rows.row_diagonal(), group=self.row_group, offset=self.offset,
                    column=self.rows.pivot_column)
        if not (block_size and block_size > 1 and rank > block_size):
            return pivoted_cholesky_with_pivots(self.rows, rank, **rows)
        pivots = []

        def build():
            L, piv = blocked_pivoted_cholesky_with_pivots(self.rows, rank, None, block_size, pool=self.rows.pool,
                                                          **rows)
            pivots.append(piv)
            return L

        return _forward_only(self.rows, build), pivots[0]

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
        share of the replicated tensors' gradients, which
        ``_comm.sum_grads`` sums over the model group, so every rank holds
        the whole gradient; the rank's own rows keep their own."""
        leaves, own = list(self._leaves()), self.own_leaves()
        shared = iter(_comm.sum_grads(tuple(t for t, o in zip(leaves, own) if not o), self.row_group))
        op = self._with_leaves([t if o else next(shared) for t, o in zip(leaves, own)])
        block = op.rows.block()
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

    def zero_mean_mvn_samples(self, num_samples: int, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """The rank's rows of the unsharded draws, R z with R the rank's rows
        of the root and z (k, s) drawn whole (see the base class)."""
        if settings.ciq_samples.on():
            raise _queued("zero_mean_mvn_samples under settings.ciq_samples (sqrt_inv_matmul)")
        return super().zero_mean_mvn_samples(num_samples, generator=generator)

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
    "sqrt_inv_matmul", "_getitem", "_get_indices", "_select_rows", "_select_cols", "cat_rows", "add_low_rank", "mul",
    "_expand_batch",
):
    setattr(RowShardedLinearOperator, _name, _queued_method(_name))


def _row_sizes(rows: int, mesh, device) -> tuple:
    """The row counts of the rank's model group, exchanged in one sum (they
    may be uneven)."""
    counts = torch.zeros(mesh.size("model"), dtype=torch.float64, device=device)
    counts[mesh.index("model")] = rows
    return tuple(int(c) for c in _comm.all_reduce(counts, mesh.group("model")).tolist())


def row_sharded_kernel_operator(x, params: dict, mesh, **kernel_kwargs) -> RowShardedLinearOperator:
    """The rank's rows of the kernel operator k(x, x) on ``mesh``'s model
    axis, from the rank's rows ``x`` (*b, |R|, d): x is gathered over the
    model group, differentiably (``_comm.gather_rows``: x may require a
    gradient), and the rows are a rectangular ``KernelLinearOperator`` on
    (x_R, x) with ``kernel_kwargs``."""
    from ..operators.kernel import KernelLinearOperator

    group = mesh.group("model")
    sizes = _row_sizes(x.shape[-2], mesh, x.device)
    x_all = _comm.gather_rows(x, group, sizes)
    rows = KernelLinearOperator(x, x_all, params, symmetric=False, **kernel_kwargs)
    return RowShardedLinearOperator(KernelRows(rows, sizes, group), None, mesh)


def row_sharded_interpolated_operator(base: LinearOperator, indices: torch.Tensor, values: torch.Tensor,
                                      mesh) -> RowShardedLinearOperator:
    """The rank's rows of W K_grid W^T on ``mesh``'s model axis (SKI), from
    the grid operator ``base`` (replicated) and the flat stencils of the
    rank's own points, ``indices`` and ``values`` (*b, |R|, k); ``values``
    may require a gradient (the interpolation weights of a trainable x)."""
    sizes = _row_sizes(indices.shape[-2], mesh, values.device)
    return RowShardedLinearOperator(InterpolatedRows(base, indices, values, sizes, mesh.group("model")), None, mesh)
