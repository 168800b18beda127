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
  (one sum of (r, t) an application); its operator P = L L^T + D is
  itself row-sharded, its product summing L_R^T v_R over the group
  ("precond"), as the nested P^{1/2} quadrature of CIQ needs;
* ``solve``, through ``SolveLayout``'s reduction for a solve;
* the Cholesky route (``to_dense``, ``_solve_structure``): at n <=
  ``max_cholesky_size`` the unsharded operator forms K and factors it, so
  here the rows are formed (SKI's stencils gathered once), gathered once,
  and every rank factors the same n x n matrix, as GSPMD does.  That is the
  route's own n x n, not a fallback;
* Lanczos and the roots (``functions/_root_decomposition.py``): the rank's
  rows of the root, the inverse root and ``diagonalization``'s vectors
  (the eigenvalues whole), their gradients (shares summed once), and
  ``zero_mean_mvn_samples``, the rank's rows of the unsharded draw (under
  ``settings.ciq_samples`` too: the base draw whole, then cut);
* ``sqrt_inv_matmul`` (CIQ): MINRES and the range estimate's Lanczos sum
  their inner products over the group ("minres", "lanczos"), the
  backward sums the operator's gradient shares once;
* a gradient in SKI's interpolation weights: W_R's own, from K_grid W^T
  right (the forward's sum) and K_grid W^T left (a second sum,
  "interp_left");
* indexing (``_getitem``, ``_select_rows``, ``_select_cols``,
  ``_get_indices``): an index that cuts only the batch, or a full row
  slice, keeps the rank's rows (a full row slice with a column index gives
  the rank's rows K[R, J] as a local operator whose products take whole
  vectors of J); any other row index gives K[I, J], the same on every rank:
  a lazy kernel operator on the gathered x (K1, K3 for a square block), or
  W_I K_grid W_J^T with I's and J's stencils from their owners in one
  collective ("index").  D's block is lazy (:class:`DiagBlock`, or D's own
  slice on a square block).  Nothing densifies;
* the algebra, each result row-sharded over the same group: a sum with a
  root (:class:`RootRows`, one sum of (r, t) a product, "low_rank"),
  another row-sharded operator (:class:`SumRows`), a dense tensor of the
  rank's rows or a scalar (:class:`OperatorRows`, the rank's rows of the
  dense result), ``add_low_rank`` (with a carried root, the root's rows
  [R_R | V_R]), ``mul`` (the row-wise products of two roots' rows, one
  sum of (k1 k2, t) a product), a constant multiple
  (:class:`ScaledRows`), ``cat_rows`` (:class:`CatRows`: the group's last
  rank owns the m new rows; a product sums B_R^T v_R and the new rows'
  vector in one collective, "cat_rows"; with a carried root, the
  block-triangular root's rows, its Schur factor the same on every rank)
  and a batch expansion (the rows' tensors broadcast).  K + D plus an
  operator keeps D outside and its preconditioner, as the unsharded
  AddedDiag's sum does (the summands' diagonal, pivots and landmarks come
  from their products with unit vectors); add_low_rank, a tensor, a
  scalar, mul and cat_rows give results with no diagonal and so no
  preconditioner, as unsharded.
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
from ..operators.low_rank_root_added_diag import LowRankRootAddedDiagLinearOperator
from ..utils.sparse import left_interp, left_t_interp
from . import _comm


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

    # ---- indexing and the batch --------------------------------------------

    def _whole(self) -> LinearOperator:
        """k(x, x) on the gathered points, the same on every rank."""
        return self.kernel._replace(x1=self.kernel.x2, symmetric=True)

    def batch_cut(self, batch: tuple) -> "KernelRows":
        return KernelRows(self.kernel._getitem(slice(None), slice(None), *batch), self.sizes, self.group)

    def row_block(self, col) -> LinearOperator:
        """K[R, col] (a slice or a 1-D index tensor), no collective: the
        kernel's own indexing of its columns."""
        return _index_cols(self.kernel, col)

    def whole_block(self, row, col) -> LinearOperator:
        """K[row, col] on the gathered points, no collective: K1, or K3 on
        a square block (equal slices)."""
        whole = self._whole()
        if isinstance(row, slice) and isinstance(col, slice):
            return _sub(whole, row, col)
        return _index_cols(whole._select_rows(row) if torch.is_tensor(row) else _sub(whole, row, slice(None)), col)

    def entries(self, row, col, *batch) -> torch.Tensor:
        return self._whole()._get_indices(row, col, *batch)

    def _expand_rows(self, batch: tuple) -> "KernelRows":
        x1, x2 = self.kernel.x1, self.kernel.x2
        return KernelRows(self.kernel._replace(x1=x1.expand(*batch, *x1.shape[-2:]),
                                               x2=x2.expand(*batch, *x2.shape[-2:])), self.sizes, self.group)


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

    # ---- indexing and the batch --------------------------------------------

    def batch_cut(self, batch: tuple) -> "InterpolatedRows":
        shape, base = self.batch_shape, self.base
        if base.batch_shape:
            base = base._expanded_to(shape)._getitem(slice(None), slice(None), *batch)

        def cut(t):
            return t.expand(*shape, *t.shape[-2:])[(*batch, slice(None), slice(None))]

        return InterpolatedRows(base, cut(self.indices), cut(self.values), self.sizes, self.group)

    def row_block(self, col) -> LinearOperator:
        """W_R K_grid W_col^T, col's stencils from their owners ("index")."""
        li, lv, _ = self._stencils(_as_index(col, self.shape[-1], self.indices.device), "index")
        return InterpolatedLinearOperator(self.base, self.indices, self.values, li, lv)

    def whole_block(self, row, col) -> LinearOperator:
        """W_row K_grid W_col^T, the rows' and columns' stencils from their
        owners in one collective ("index")."""
        n, dev = self.shape[-1], self.indices.device
        rows, cols = _as_index(row, n, dev), _as_index(col, n, dev)
        li, lv, _ = self._stencils(torch.cat([rows, cols]), "index")
        i = len(rows)
        return InterpolatedLinearOperator(self.base, li[..., :i, :], lv[..., :i, :], li[..., i:, :], lv[..., i:, :])

    def entries(self, row, col, *batch) -> torch.Tensor:
        """Pointwise K[row, col] over broadcast index tensors: the stencils of
        every row and column index from their owners in one collective."""
        shape = torch.broadcast_shapes(*(torch.as_tensor(t).shape for t in (row, col, *batch)))
        flat = [torch.as_tensor(t, device=self.indices.device).expand(shape).reshape(-1) for t in (row, col, *batch)]
        j = flat[0].numel()
        li, lv, _ = self._stencils(torch.cat(flat[:2]), "index")
        op = InterpolatedLinearOperator(self.base, li[..., :j, :], lv[..., :j, :], li[..., j:, :], lv[..., j:, :])
        at = torch.arange(j, device=li.device)
        return op._get_indices(at, at, *flat[2:]).reshape(shape)

    def _expand_rows(self, batch: tuple) -> "InterpolatedRows":
        return InterpolatedRows(self.base, self.indices.expand(*batch, *self.indices.shape[-2:]),
                                self.values.expand(*batch, *self.values.shape[-2:]), self.sizes, self.group)


def _at_stencils(indices: torch.Tensor, grid_vecs: torch.Tensor) -> torch.Tensor:
    """Grid vectors (*b, M, t) at each row's stencil points, (*b, rows, k, t)."""
    batch = torch.broadcast_shapes(tuple(indices.shape[:-2]), tuple(grid_vecs.shape[:-2]))
    rows, k = indices.shape[-2:]
    flat = indices.expand(*batch, rows, k).reshape(*batch, rows * k, 1)
    got = torch.take_along_dim(grid_vecs.expand(*batch, *grid_vecs.shape[-2:]), flat, dim=-2)
    return got.reshape(*batch, rows, k, grid_vecs.shape[-1])


def _as_index(ix, n: int, device) -> torch.Tensor:
    """A slice or an index tensor of a dim of size n as a 1-D index tensor."""
    if isinstance(ix, slice):
        return torch.arange(*ix.indices(n), device=device)
    return torch.as_tensor(ix, device=device)


def _sub(op: LinearOperator, row, col) -> LinearOperator:
    """op[..., row, col] for two slices (every batch dim whole)."""
    return op._getitem(row, col, *(slice(None),) * len(op.batch_shape))


def _index_cols(op: LinearOperator, col) -> LinearOperator:
    """op[..., :, col]: itself for a full slice, its own slice or lazy
    column selection otherwise."""
    n = op.shape[-1]
    if isinstance(col, slice):
        return op if col.indices(n) == (0, n, 1) else _sub(op, slice(None), col)
    return op._select_cols(col)


def _own_count(sizes: tuple, group) -> int:
    return sizes[0 if group is None else group.index]


class DiagBlock(LinearOperator):
    """D[rows, cols] of a diagonal D with diagonal ``diag`` (*b, n), for 1-D
    global index tensors: entry (i, c) is d[rows[i]] where rows[i] ==
    cols[c], else 0 (an index may repeat).  Lazy: a product scatters the
    vector onto the n indices and gathers it back at ``rows``, O(n t)."""

    def __init__(self, diag: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
        self.diag = diag
        self.rows = rows
        self.cols = cols

    def _shape(self) -> tuple[int, ...]:
        return (*self.diag.shape[:-1], len(self.rows), len(self.cols))

    def _transpose(self) -> "DiagBlock":
        return DiagBlock(self.diag, self.cols, self.rows)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        batch = torch.broadcast_shapes(self.diag.shape[:-1], rhs.shape[:-2])
        rhs = rhs.expand(*batch, *rhs.shape[-2:])
        at = torch.zeros((*batch, self.diag.shape[-1], rhs.shape[-1]), dtype=rhs.dtype, device=rhs.device)
        at = at.index_add(-2, self.cols, rhs)
        return self.diag[..., self.rows, None] * at[..., self.rows, :]

    def to_dense(self) -> torch.Tensor:
        same = (self.rows[:, None] == self.cols[None, :]).to(self.diag.dtype)
        return self.diag[..., self.rows, None] * same

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        diag = self.diag.expand(*self.batch_shape, self.diag.shape[-1])
        r, c = self.rows[row_index], self.cols[col_index]
        vals = diag[(*batch_indices, r)]
        return torch.where(r == c, vals, torch.zeros_like(vals))

    def _diagonal(self) -> torch.Tensor:
        vals = self.diag[..., self.rows]
        return torch.where(self.rows == self.cols, vals, torch.zeros_like(vals))

    def _expand_batch(self, batch_shape) -> "DiagBlock":
        return DiagBlock(self.diag.expand(*batch_shape, self.diag.shape[-1]), self.rows, self.cols)


class _Rows(LinearOperator):
    """What the row-sharded operator asks of the algebra's rows beyond a
    product that takes and returns the rank's rows: ``sizes`` and
    ``group``, the tensors that are the rank's own (``owned``), the dense
    rows (``block``, the Cholesky route's), a batch expansion and a batch
    cut, and what a preconditioner of K + D asks of K's rows when D stays
    outside the sum (AddedDiag's ``__add__``): their diagonal
    (``row_diagonal``), a pivot's column, the landmarks' and a pool's
    columns, each column from one product with unit vectors."""

    def _shape(self) -> tuple[int, ...]:
        return (*self._batch(), _own_count(self.sizes, self.group), sum(self.sizes))

    @property
    def offset(self) -> int:
        """The global index of the rank's first row."""
        return 0 if self.group is None else sum(self.sizes[: self.group.index])

    def _gather(self, v: torch.Tensor) -> torch.Tensor:
        return _comm.all_gather_rows(v, self.group, self.sizes)

    def owned(self) -> tuple:
        return ()

    def _unit(self, idx: torch.Tensor) -> torch.Tensor:
        """The rank's rows of the identity's columns ``idx`` (global, (*b, j)
        or (j,)), (*b, |R|, j)."""
        own = torch.arange(self.offset, self.offset + self.shape[-2], device=idx.device)
        return (own[:, None] == idx[..., None, :]).to(self.dtype)

    def pivot_column(self, pivot: torch.Tensor) -> torch.Tensor:
        """K's column ``pivot`` (global, (*b,)) on the rank's rows."""
        return self._matmul(self._unit(pivot[..., None]))[..., 0]

    def landmarks(self, idx: torch.Tensor) -> tuple:
        """(K[R, idx], K[idx, idx]): the landmarks' rows from their owners
        ("landmarks")."""
        cols = self._matmul(self._unit(idx))
        at = idx.expand(*cols.shape[:-2], len(idx))
        return cols, _comm.owner_rows(cols, at, self.group, self.offset, name="landmarks")

    def pool(self, idx: torch.Tensor, extra: torch.Tensor) -> tuple:
        """(K[R, idx], K[idx, idx], extra's rows idx) for global indices
        ``idx`` (j,) of unbatched rows: the pool's rows of both from their
        owners in one collective ("pool")."""
        cols = self._matmul(self._unit(idx))
        got = _comm.owner_rows(torch.cat([cols, extra.to(cols.dtype)], dim=-1), idx, self.group, self.offset,
                               name="pool")
        return cols, got[..., : len(idx)], got[..., len(idx):]

    def _batch_of(self, t: torch.Tensor, batch: tuple) -> torch.Tensor:
        """A (*b, r, c) tensor of these rows broadcast to their batch and cut
        by ``batch``."""
        return t.expand(*self.batch_shape, *t.shape[-2:])[(*batch, slice(None), slice(None))]

    def row_block(self, col) -> LinearOperator:
        raise TypeError(f"indexing a row-sharded operator's columns or rows takes a kernel operator's or SKI's rows, "
                        f"not {type(self).__name__}'s: index the operands before the algebra")

    whole_block = entries = row_block


class RootRows(_Rows):
    """The rank's rows of R R^T from the rank's rows ``root`` (*b, |R|, k)
    of R: a product is R_R (sum over the group of R_R^T v_R), one sum of
    (k, t) (named ``name``, "low_rank" by default)."""

    def __init__(self, root: torch.Tensor, sizes: tuple, group, name: str = "low_rank"):
        self.root = root
        self.sizes = tuple(sizes)
        self.group = group
        self.name = name

    def _batch(self) -> tuple:
        return tuple(self.root.shape[:-2])

    def _project(self, rhs: torch.Tensor) -> torch.Tensor:
        return _comm.all_reduce(self.root.mT @ rhs, self.group, name=self.name)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.root @ self._project(rhs)

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """R_R's whole gradient (its own rows): left_R (R^T right)^T +
        right_R (R^T left)^T, both projections in one sum."""
        if not self.root.requires_grad:
            return (None,)
        t = left_vecs.shape[-1]
        both = _comm.all_reduce(self.root.mT @ torch.cat([left_vecs, right_vecs], dim=-1), self.group,
                                name=self.name)
        g = left_vecs @ both[..., t:].mT + right_vecs @ both[..., :t].mT
        return (_unbroadcast(g, self.root.shape),)

    def owned(self) -> tuple:
        return (self.root,)

    def row_diagonal(self) -> torch.Tensor:
        return torch.sum(self.root * self.root, dim=-1)

    def block(self) -> torch.Tensor:
        return self.root @ _comm.gather_rows(self.root, self.group, self.sizes).mT

    def _expand_rows(self, batch: tuple) -> "RootRows":
        return RootRows(self.root.expand(*batch, *self.root.shape[-2:]), self.sizes, self.group, self.name)

    def batch_cut(self, batch: tuple) -> "RootRows":
        return RootRows(self._batch_of(self.root, batch), self.sizes, self.group, self.name)


class OperatorRows(_Rows):
    """The rank's rows of a matrix as an operator ``op`` (*b, |R|, n) whose
    products take the whole vector (a dense tensor's rows): a product
    gathers the vector once.  ``op``'s tensors are the rank's own."""

    def __init__(self, op: LinearOperator, sizes: tuple, group):
        self.op = op
        self.sizes = tuple(sizes)
        self.group = group

    def _batch(self) -> tuple:
        return tuple(self.op.batch_shape)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.op._matmul(self._gather(rhs))

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        return self.op._bilinear_derivative(left_vecs, self._gather(right_vecs))

    def owned(self) -> tuple:
        return tuple(self.op._leaves())

    def row_diagonal(self) -> torch.Tensor:
        """The entries (i, offset + i), pointwise."""
        batch, rows = tuple(self.batch_shape), self.shape[-2]
        own = torch.arange(rows, device=self.device).expand(*batch, rows)
        return self.op._get_indices(own, own + self.offset, *_batch_aranges(batch, (rows,), self.device))

    def block(self) -> torch.Tensor:
        return self.op.to_dense()

    def _expand_rows(self, batch: tuple) -> "OperatorRows":
        return OperatorRows(self.op._expand_batch(batch), self.sizes, self.group)

    def batch_cut(self, batch: tuple) -> "OperatorRows":
        op = self.op._expanded_to(self.batch_shape)._getitem(slice(None), slice(None), *batch)
        return OperatorRows(op, self.sizes, self.group)


class SumRows(_Rows):
    """The rank's rows of a sum: ``terms``, each the rows of one summand
    (a row-sharded operator, or rows such as :class:`RootRows`) on the same
    group and sizes."""

    def __init__(self, terms: tuple):
        self.terms = tuple(terms)

    @property
    def sizes(self) -> tuple:
        return self.terms[0].sizes

    @property
    def group(self):
        return _group_of(self.terms[0])

    def _batch(self) -> tuple:
        return tuple(torch.broadcast_shapes(*(tuple(t.batch_shape) for t in self.terms)))

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        out = self.terms[0]._matmul(rhs)
        for t in self.terms[1:]:
            out = out + t._matmul(rhs)
        return out

    def _matmul_closure(self):
        closures = [t._matmul_closure() for t in self.terms]

        def mm(rhs: torch.Tensor) -> torch.Tensor:
            out = closures[0](rhs)
            for c in closures[1:]:
                out = out + c(rhs)
            return out

        return mm

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        return tuple(g for t in self.terms for g in t._bilinear_derivative(left_vecs, right_vecs))

    def owned(self) -> tuple:
        return tuple(o for t in self.terms for o in t.owned())

    def row_diagonal(self) -> torch.Tensor:
        out = self.terms[0].row_diagonal()
        for t in self.terms[1:]:
            out = out + t.row_diagonal()
        return out

    def block(self) -> torch.Tensor:
        out = self.terms[0].block()
        for t in self.terms[1:]:
            out = out + t.block()
        return out

    def _expand_rows(self, batch: tuple) -> "SumRows":
        return SumRows(tuple(t._expand_rows(batch) for t in self.terms))

    def batch_cut(self, batch: tuple) -> "SumRows":
        shape = self.batch_shape
        return SumRows(tuple((t if tuple(t.batch_shape) == shape else t._expand_rows(shape)).batch_cut(batch)
                             for t in self.terms))


class ScaledRows(_Rows):
    """The rank's rows of c K: ``term`` the rows of K, ``scale`` a scalar or
    a batch-shaped constant, replicated (its gradient a share)."""

    def __init__(self, term: LinearOperator, scale: torch.Tensor):
        self.term = term
        self.scale = scale

    @property
    def sizes(self) -> tuple:
        return self.term.sizes

    @property
    def group(self):
        return _group_of(self.term)

    def _batch(self) -> tuple:
        return tuple(torch.broadcast_shapes(tuple(self.term.batch_shape), tuple(self.scale.shape)))

    def _c(self) -> torch.Tensor:
        return self.scale[..., None, None]

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._c() * self.term._matmul(rhs)

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        grads = self.term._bilinear_derivative(self._c() * left_vecs, right_vecs)
        g = None
        if self.scale.requires_grad:
            g = _unbroadcast(torch.sum(left_vecs * self.term._matmul(right_vecs), dim=(-2, -1)), self.scale.shape)
        return (*grads, g)

    def owned(self) -> tuple:
        return self.term.owned()

    def row_diagonal(self) -> torch.Tensor:
        return self.scale[..., None] * self.term.row_diagonal()

    def block(self) -> torch.Tensor:
        return self._c() * self.term.block()

    def _expand_rows(self, batch: tuple) -> "ScaledRows":
        return ScaledRows(self.term._expand_rows(batch), self.scale)

    def batch_cut(self, batch: tuple) -> "ScaledRows":
        shape = self.batch_shape
        term = self.term if tuple(self.term.batch_shape) == shape else self.term._expand_rows(shape)
        return ScaledRows(term.batch_cut(batch), self.scale.expand(shape)[batch])


class CatRows(_Rows):
    """The rank's rows of the fantasy operator [[K, B], [B^T, C]]: ``inner``
    the row-sharded K (its products take and return the rank's old rows),
    ``cross`` the rank's rows B_R (*b, |R|, m) of B, ``new`` C (*b, m, m),
    the same on every rank; ``sizes`` the new row counts, the group's last
    rank owning the m new rows after its old ones.  A product is K's, the
    rank's B_R v_new, and one sum of (2m, t) over the group ("cat_rows"):
    B^T v's m rows and the new rows' v_new, which the last rank holds."""

    def __init__(self, inner: LinearOperator, cross: torch.Tensor, new: torch.Tensor, sizes: tuple, group):
        self.inner = inner
        self.cross = cross
        self.new = new
        self.sizes = tuple(sizes)
        self.group = group

    def _batch(self) -> tuple:
        return tuple(torch.broadcast_shapes(tuple(self.inner.batch_shape), tuple(self.cross.shape[:-2]),
                                            tuple(self.new.shape[:-2])))

    @property
    def last(self) -> bool:
        return self.group is None or self.group.index == self.group.size - 1

    def _split(self, v: torch.Tensor) -> tuple:
        old = self.inner.sizes[0 if self.group is None else self.group.index]
        return v[..., :old, :], v[..., old:, :]

    def _sum(self, parts: list, new: list) -> list:
        """[B^T p for p in parts] + new (the last rank's new rows of each
        vector, zeros elsewhere), summed over the group in one collective."""
        m = self.new.shape[-1]
        both = [self.cross.mT @ p for p in parts]
        both += [q if self.last else q.new_zeros((*q.shape[:-2], m, q.shape[-1])) for q in new]
        batch = torch.broadcast_shapes(*(t.shape[:-2] for t in both))
        total = _comm.all_reduce(torch.cat([t.expand(*batch, *t.shape[-2:]) for t in both], dim=-1), self.group,
                                 name="cat_rows")
        return list(torch.split(total, [t.shape[-1] for t in both], dim=-1))

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        old, new = self._split(rhs)
        bt_v, v_new = self._sum([old], [new])
        out = self.inner._matmul(old) + self.cross @ v_new
        if self.last:
            out = torch.cat([out, (bt_v + self.new @ v_new).expand(*out.shape[:-2], *bt_v.shape[-2:])], dim=-2)
        return out

    def _bilinear_derivative(self, left_vecs, right_vecs) -> tuple:
        """K's share on the old rows; B_R's whole gradient (its own rows),
        left_R r_new^T + right_R l_new^T, and C's share (the last rank's
        l_new r_new^T, zeros elsewhere), from one sum of the new rows of both
        vectors."""
        lo, ln = self._split(left_vecs)
        ro, rn = self._split(right_vecs)
        l_new, r_new = self._sum([], [ln, rn])
        grads = list(self.inner._bilinear_derivative(lo, ro))
        g_cross = _unbroadcast(lo @ r_new.mT + ro @ l_new.mT, self.cross.shape) if self.cross.requires_grad else None
        g_new = None
        if self.new.requires_grad:
            g_new = l_new @ r_new.mT
            g_new = _unbroadcast(g_new if self.last else torch.zeros_like(g_new), self.new.shape)
        return (*grads, g_cross, g_new)

    def owned(self) -> tuple:
        return (*self.inner.owned(), self.cross)

    def row_diagonal(self) -> torch.Tensor:
        """K's diagonal on the rank's old rows, then C's on the last rank."""
        old = self.inner.row_diagonal()
        if not self.last:
            return old
        new = torch.diagonal(self.new, dim1=-2, dim2=-1)
        batch = torch.broadcast_shapes(old.shape[:-1], new.shape[:-1])
        return torch.cat([old.expand(*batch, old.shape[-1]), new.expand(*batch, new.shape[-1])], dim=-1)

    def block(self) -> torch.Tensor:
        """[K_R | B_R] and, on the last rank, [B^T | C] below: B gathered
        once (its gradient summed over the group: only the last rank uses
        it whole)."""
        top = torch.cat([self.inner.block(), self.cross.expand(*self.inner.batch_shape, *self.cross.shape[-2:])],
                        dim=-1)
        (whole,) = _comm.sum_grads((_comm.gather_rows(self.cross, self.group, self.inner.sizes),), self.group)
        if not self.last:
            return top
        bottom = torch.cat([whole.mT, self.new], dim=-1)
        batch = torch.broadcast_shapes(top.shape[:-2], bottom.shape[:-2])
        return torch.cat([top.expand(*batch, *top.shape[-2:]), bottom.expand(*batch, *bottom.shape[-2:])], dim=-2)

    def _expand_rows(self, batch: tuple) -> "CatRows":
        return CatRows(self.inner._expand_rows(batch), self.cross.expand(*batch, *self.cross.shape[-2:]),
                       self.new.expand(*batch, *self.new.shape[-2:]), self.sizes, self.group)

    def batch_cut(self, batch: tuple) -> "CatRows":
        shape = self.batch_shape
        inner = self.inner if tuple(self.inner.batch_shape) == shape else self.inner._expand_rows(shape)
        return CatRows(inner.batch_cut(batch), self._batch_of(self.cross, batch), self._batch_of(self.new, batch),
                       self.sizes, self.group)


def _group_of(rows) -> "_comm.Group | None":
    return rows.row_group if isinstance(rows, RowShardedLinearOperator) else rows.group


class RowShardedLinearOperator(LinearOperator):
    """Rows R of K + D over a model group: ``rows`` the rank's rows of K
    (a :class:`KernelRows` or an :class:`InterpolatedRows`, or the algebra's
    rows, whose products take and return the rank's rows), ``diag`` a DiagLinearOperator of the
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

    def row_diagonal(self) -> torch.Tensor:
        """K + D's diagonal on the rank's rows, (*b, |R|) (a summand's)."""
        out = self.rows.row_diagonal()
        return out if self.diag is None else out + self._diag_rows()

    def own_leaves(self) -> list:
        """For each of ``_leaves()``, whether it is the rank's own rows
        (x_R, W_R's stencils), whose gradient is never summed over the
        model group; the rest are replicated, their gradients shares."""
        owned = self.rows.owned()
        return [any(t is o for o in owned) for t in self._leaves()]

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        out = self.rows._matmul(rhs)
        return out if self.diag is None else out + self.diag._matmul(rhs)

    def matmul(self, other):
        """K @ other for the rank's rows of a tensor (a vector as a column):
        the rank's rows of the product."""
        if isinstance(other, LinearOperator):
            return super().matmul(other)
        return self._matmul(other[..., None])[..., 0] if other.ndim == 1 else self._matmul(other)

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
        D (a product sums L_R^T v_R over the group; its draws,
        ``zero_mean_mvn_samples(..., layout=)``, are the rank's rows of the
        unsharded ones) and log det P is whole.  None where the
        unsharded operator would take none."""
        from ..operators.low_rank_root_added_diag import woodbury_solve_closure

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
        precond_op = RowShardedPreconditioner(RootRows(L, self.sizes, self.row_group, name="precond"), self.diag,
                                              self.mesh)
        return closure, precond_op, logdet_p

    # ---- solves and the Cholesky route -------------------------------------

    def block(self) -> torch.Tensor:
        """The rank's dense rows of K + D, (*b, |R|, n)."""
        block = self.rows.block()
        if self.diag is not None:
            eye = torch.eye(block.shape[-1], dtype=block.dtype, device=block.device)[self.row_slice()]
            block = block + self._diag_rows()[..., None] * eye
        return block

    def _rows_dense(self) -> torch.Tensor:
        """:meth:`block`, differentiable as every rank's rows of one matrix:
        each rank's rows carry its share of the replicated tensors'
        gradients, which ``_comm.sum_grads`` sums over the model group, so
        that every rank holds the whole gradient; the rank's own rows keep
        their own."""
        leaves, own = list(self._leaves()), self.own_leaves()
        shared = iter(_comm.sum_grads(tuple(t for t, o in zip(leaves, own) if not o), self.row_group))
        return self._with_leaves([t if o else next(shared) for t, o in zip(leaves, own)]).block()

    def to_dense(self) -> torch.Tensor:
        """The whole K + D, (*b, n, n), the same on every rank: the rank's
        rows formed and gathered once over the model group.  Only the
        Cholesky route takes it, at n <= ``max_cholesky_size``, where the
        unsharded operator forms the same matrix: it is that route's own
        n x n, not a fallback."""
        return _comm.gather_rows(self._rows_dense(), self.row_group, self.sizes)

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
        """The rank's rows of the unsharded draws: R z with R the rank's rows
        of the root and z (k, s) drawn whole, or under
        ``settings.ciq_samples`` K^{1/2} z by CIQ with the base z (*b, n, s)
        drawn whole and cut to the rank's rows (see the base class)."""
        if not settings.ciq_samples.on():
            return super().zero_mean_mvn_samples(num_samples, generator=generator)
        from ..functions import sqrt_matmul_ciq
        from ..utils.random import randn
        from .sharding import solve_layout

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        layout = solve_layout(self)
        whole = randn((*layout.batch, self.shape[-1], num_samples), self.dtype, self.device, generator)
        base = layout.draw_block(whole.movedim(-1, 0), rows=True).movedim(0, -1)
        return sqrt_matmul_ciq(self, base, generator=generator).movedim(-1, 0)

    # ---- the algebra -------------------------------------------------------

    def _like(self, rows: LinearOperator) -> "RowShardedLinearOperator":
        """A row-sharded operator on the same mesh with ``rows`` and no
        diagonal."""
        return RowShardedLinearOperator(rows, None, self.mesh)

    def owned(self) -> tuple:
        return self.rows.owned()

    def _rows_of(self, other):
        """``other`` (a tensor or an operator) as rows of this group: the
        rank's rows (*b, |R|, n) as they are, a whole (*b, n, n) cut to
        them."""
        from ..operators.dense import DenseLinearOperator

        op = other if isinstance(other, LinearOperator) else DenseLinearOperator(
            torch.as_tensor(other, dtype=self.dtype, device=self.device))
        n, rows = self.shape[-1], self.rows.shape[-2]
        if tuple(op.matrix_shape) == (n, n):
            op = _sub(op, self.row_slice(), slice(None))
        elif tuple(op.matrix_shape) != (rows, n):
            raise ValueError(f"a row-sharded operator of {n} x {n} adds the rank's ({rows}, {n}) rows or the whole "
                             f"{n} x {n}, not {tuple(op.matrix_shape)}")
        return OperatorRows(op, self.sizes, self.row_group)

    def __add__(self, other):
        """A diagonal joins D; a root (the rank's rows of V) gives
        ``add_low_rank``; another row-sharded operator on the same group and
        sizes, a dense tensor or operator (the rank's rows, or the whole n x
        n cut to them) a lazy sum of rows; a scalar the rank's rows of the
        dense result.  As the unsharded AddedDiag's sum, K + D plus an
        operator is (K + other) + D, with D outside and a preconditioner; a
        tensor or a scalar joins the whole K + D."""
        from ..operators.diag import DiagLinearOperator
        from ..operators.root import RootLinearOperator
        from ..operators.zero import ZeroLinearOperator

        if isinstance(other, ZeroLinearOperator):
            return self
        if isinstance(other, DiagLinearOperator):
            return self._replace(diag=other if self.diag is None else self.diag + other)
        if self.diag is not None and isinstance(other, LinearOperator):
            # D stays outside, so the sum keeps its preconditioner (AddedDiag's sum)
            return RowShardedLinearOperator((self._like(self.rows) + other).rows, self.diag, self.mesh)
        if isinstance(other, RootLinearOperator):
            return self.add_low_rank(other.root)
        if isinstance(other, RowShardedLinearOperator):
            if other.sizes != self.sizes or other.row_group.ranks != self.row_group.ranks:
                raise ValueError("row-sharded operators add on one model group with the same row counts")
            return self._like(SumRows((self, other)))
        if not isinstance(other, LinearOperator) and torch.as_tensor(other).ndim == 0:
            from ..operators.dense import DenseLinearOperator

            return self._like(OperatorRows(DenseLinearOperator(self._rows_dense() + other), self.sizes,
                                           self.row_group))
        return self._like(SumRows((self, self._rows_of(other))))

    def _carried_root(self) -> LinearOperator | None:
        """The rank's rows of the root this operator carries (a row-sharded
        R R^T: ``with_factorization``, ``add_low_rank``, ``cat_rows``,
        ``mul``), or None."""
        from ..operators.dense import DenseLinearOperator

        if isinstance(self.rows, RootRows) and self.diag is None:
            return DenseLinearOperator(self.rows.root)
        return None

    def _root_structure(self) -> LinearOperator | None:
        return self._carried_root()

    def with_factorization(self, factor: LinearOperator) -> "RowShardedLinearOperator":
        """The row-sharded R R^T from a factorization of this operator: a
        root decomposition's root (the rank's rows), or a Cholesky factor
        (whole on every rank, its rows cut with ``_comm.own_rows``)."""
        from ..operators.triangular import TriangularLinearOperator

        if isinstance(factor, TriangularLinearOperator):
            L = factor.to_dense()
            root = _comm.own_rows(L.mT if factor.upper else L, self.row_group, self.sizes)
        else:
            root = (factor.root if hasattr(factor, "root") else factor).to_dense()
        return self._like(RootRows(root, self.sizes, self.row_group))

    def add_low_rank(self, low_rank_mat, generate_roots: bool = True) -> "RowShardedLinearOperator":
        """K + V V^T from the rank's rows of V (*b, |R|, r): with a carried
        root R and ``generate_roots``, the row-sharded root [R_R | V_R];
        otherwise a lazy sum with V's rows (one sum of (r, t) a product)."""
        v = low_rank_mat.to_dense() if isinstance(low_rank_mat, LinearOperator) else torch.as_tensor(
            low_rank_mat, dtype=self.dtype, device=self.device)
        if v.ndim == 1:
            v = v[:, None]
        root = self._carried_root() if generate_roots else None
        if root is not None:
            r = root.to_dense()
            batch = torch.broadcast_shapes(r.shape[:-2], v.shape[:-2])
            joined = torch.cat([r.expand(*batch, *r.shape[-2:]), v.expand(*batch, *v.shape[-2:])], dim=-1)
            return self._like(RootRows(joined, self.sizes, self.row_group))
        return self._like(SumRows((self, RootRows(v, self.sizes, self.row_group))))

    def _root_rows(self) -> torch.Tensor:
        """The rank's rows of a root (the carried one, else
        ``root_decomposition``'s)."""
        return self.root_decomposition().root.to_dense()

    def mul(self, other) -> "RowShardedLinearOperator":
        """The elementwise product: with another row-sharded operator on the
        same rows, the Hadamard product of the two root decompositions, its
        root's rows the row-wise products of the two roots' rows (one sum of
        (k1 k2, t) a product); with a scalar or a batch-shaped constant, the
        constant multiple."""
        if isinstance(other, LinearOperator):
            if not isinstance(other, RowShardedLinearOperator) or other.sizes != self.sizes:
                raise ValueError("a row-sharded operator multiplies another on the same rows")
            a, b = self._root_rows(), other._root_rows()
            batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
            a, b = a.expand(*batch, *a.shape[-2:]), b.expand(*batch, *b.shape[-2:])
            root = (a[..., :, :, None] * b[..., :, None, :]).flatten(-2)
            return self._like(RootRows(root, self.sizes, self.row_group))
        const = torch.as_tensor(other, dtype=self.dtype, device=self.device)
        if const.ndim >= 2 and tuple(const.shape[-2:]) == (1, 1):
            const = const[..., 0, 0]
        if const.ndim > self.ndim - 2:
            raise ValueError(f"a row-sharded operator multiplies a scalar, a batch-shaped constant or another "
                             f"row-sharded operator, not a tensor of {tuple(const.shape)}")
        return self._like(ScaledRows(self, const))

    def cat_rows(self, cross_mat, new_mat, generate_roots: bool = True) -> "RowShardedLinearOperator":
        """K' = [[K, B], [B^T, C]] with m new rows and columns: ``cross_mat``
        the rank's columns (*b, m, |R|) of the new rows B^T, ``new_mat`` C
        (*b, m, m) whole.  The result is row-sharded on the group's sizes
        with the last rank's count grown by m (its old rows, then the new
        ones).  With a carried root R and ``generate_roots``, the rows of the
        block-triangular root [[R, 0], [B^T K^{-1} R, S]] (K^{-1} B from
        ``solve`` on this operator; B^T K^{-1} R and the Schur complement
        C - B^T K^{-1} B summed over the group in one collective,
        "cat_rows", and factored alike on every rank); otherwise the lazy
        :class:`CatRows`, which has no preconditioner (nor has the unsharded
        Cat)."""
        from ..functions import solve
        from ..utils.cholesky import psd_safe_cholesky

        B = torch.as_tensor(cross_mat, dtype=self.dtype, device=self.device).mT  # (*b, |R|, m)
        C = torch.as_tensor(new_mat, dtype=self.dtype, device=self.device)
        m, group = C.shape[-1], self.row_group
        sizes = (*self.sizes[:-1], self.sizes[-1] + m)
        last = group.index == group.size - 1
        root_op = self._carried_root() if generate_roots else None
        if root_op is None:
            return self._like(CatRows(self, B, C, sizes, group))
        R = root_op.to_dense()  # (*b, |R|, k)
        KinvB = solve(self, B)
        k = R.shape[-1]
        # a sum that only the last rank uses: its backward sums the cotangents
        (both,) = _comm.sum_grads((_comm.sum_shares(torch.cat([KinvB.mT @ R, B.mT @ KinvB], dim=-1), group,
                                                    name="cat_rows"),), group)
        lower_left, schur = both[..., :k], C - both[..., k:]
        S = psd_safe_cholesky((schur + schur.mT) / 2.0)
        rows = torch.cat([R, R.new_zeros((*R.shape[:-1], m))], dim=-1)
        if last:
            bottom = torch.cat([lower_left, S], dim=-1)
            batch = torch.broadcast_shapes(rows.shape[:-2], bottom.shape[:-2])
            rows = torch.cat([rows.expand(*batch, *rows.shape[-2:]), bottom.expand(*batch, *bottom.shape[-2:])],
                             dim=-2)
        return self._like(RootRows(rows, sizes, group))

    def _expand_batch(self, batch_shape: tuple) -> "RowShardedLinearOperator":
        """The rows' tensors, D and the preconditioner factor broadcast to
        ``batch_shape``: nothing densifies."""
        batch = tuple(batch_shape)
        factor = self.precond_factor
        if factor is not None:
            factor = factor.expand(*batch, *factor.shape[-2:])
        diag = None if self.diag is None else self.diag._expand_batch(batch)
        return RowShardedLinearOperator(self.rows._expand_rows(batch), diag, self.mesh, factor)

    _expand_rows = _expand_batch

    def batch_cut(self, batch: tuple) -> "RowShardedLinearOperator":
        return self._batch_cut(batch)

    # ---- indexing ----------------------------------------------------------

    def _full(self, ix) -> bool:
        n = self.shape[-1]
        return isinstance(ix, slice) and ix.indices(n) == (0, n, 1)

    def _batch_cut(self, batch: tuple) -> "RowShardedLinearOperator":
        """The rank's rows of K[*batch] (basic and advanced batch indices)."""
        if not batch:
            return self
        factor = self.precond_factor
        if factor is not None:
            factor = factor.expand(*self.batch_shape, *factor.shape[-2:])[(*batch, slice(None), slice(None))]
        diag = None
        if self.diag is not None:
            diag = self.diag._expanded_to(self.batch_shape)._getitem(slice(None), slice(None), *batch)
        return RowShardedLinearOperator(self.rows.batch_cut(batch), diag, self.mesh, factor)

    def _diag_block(self, row, col) -> LinearOperator | None:
        """D[row, col], lazily: D's own slice where the two are one slice,
        else a :class:`DiagBlock` on D's whole diagonal (no collective)."""
        if self.diag is None:
            return None
        if isinstance(row, slice) and isinstance(col, slice) and row.indices(self.shape[-1]) == col.indices(
                self.shape[-1]):
            return _sub(self.diag._expanded_to(self.batch_shape), row, col)
        n, dev = self.shape[-1], self.device
        return DiagBlock(self.diag._diagonal(), _as_index(row, n, dev), _as_index(col, n, dev))

    def _with_diag_block(self, block: LinearOperator, row, col) -> LinearOperator:
        diag = self._diag_block(row, col)
        return block if diag is None else block + diag

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        """K[*batch, row, col]: an index that cuts only the batch keeps the
        operator row-sharded; a full row slice with another column index
        gives the rank's rows K[R, col] (a local operator); any other row
        index K[row, col], the same on every rank."""
        op = self._batch_cut(batch_indices)
        if self._full(row_index) and self._full(col_index):
            return op
        if self._full(row_index):
            return op._with_diag_block(op.rows.row_block(col_index), op.row_slice(), col_index)
        return op._with_diag_block(op.rows.whole_block(row_index, col_index), row_index, col_index)

    def _select_rows(self, idx: torch.Tensor) -> LinearOperator:
        """K[idx, :], the same on every rank (K1 on the card)."""
        return self._with_diag_block(self.rows.whole_block(idx, slice(None)), idx, slice(None))

    def _select_cols(self, idx: torch.Tensor) -> LinearOperator:
        """The rank's rows of K[:, idx], a local operator."""
        return self._with_diag_block(self.rows.row_block(idx), self.row_slice(), idx)

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """K's entries at broadcast global index tensors, the same on every
        rank."""
        vals = self.rows.entries(row_index, col_index, *batch_indices)
        if self.diag is not None:
            vals = vals + self.diag._expanded_to(self.batch_shape)._get_indices(row_index, col_index, *batch_indices)
        return vals


class RowShardedPreconditioner(RowShardedLinearOperator):
    """P = L L^T + D, a row-sharded operator's preconditioner operator: the
    rows are L's (:class:`RootRows`, a product sums L_R^T v_R over the group,
    "precond"), D is the operator's, so every product, solve and dense form
    is the rank's rows of the unsharded P's.  Its draws under a ``layout``
    are the rank's rows of the unsharded ones (``LowRankRootAddedDiag``'s,
    L eps1 + sqrt(D) eps2 with eps1 and eps2 drawn whole)."""

    def zero_mean_mvn_samples(self, num_samples: int, *, generator: torch.Generator | None = None,
                              layout=None) -> torch.Tensor:
        from ..operators.dense import DenseLinearOperator
        from ..operators.diag import DiagLinearOperator
        from ..operators.root import LowRankRootLinearOperator

        rows = LowRankRootAddedDiagLinearOperator(LowRankRootLinearOperator(DenseLinearOperator(self.rows.root)),
                                                  DiagLinearOperator(self._diag_rows()))
        return rows.zero_mean_mvn_samples(num_samples, generator=generator, layout=layout)


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
