"""Batched greedy pivoted (partial) Cholesky (counterpart of
linear_operator_tpu/solvers/pivoted_cholesky.py).

Everything stays in the original index order and the pivots are tracked
implicitly: each step argmaxes the residual diagonal on the device, gathers
that column through the operator's ``_get_indices`` (a kernel operator
evaluates k(X, x_pivot) and stores nothing), and writes one row of L.

The strict variant runs a fixed ``rank`` steps and never reads a value back
to the host: a batch element that has converged (trace tolerance, or a
residual pivot <= 1e-12) writes a zero row and records pivot -1, as the JAX
package's ``fori_loop`` does.  It is differentiable through autograd, with
the argmax pivots as constants.  The blocked variant is forward-only.
"""

from __future__ import annotations

import torch

from .. import settings
from ..utils.cholesky import highest_matmul_precision


def pivoted_cholesky(op, rank: int, error_tol: float | None = None, block_size: int | None = None):
    """L (*b, n, rank) with L L^T ~= K, by greedy trace pivoting.

    ``block_size`` (default ``settings.pivoted_cholesky_block_size``) > 1
    takes the blocked sweep of :func:`_blocked_pivoted_cholesky`, which is
    forward-only; otherwise the strict greedy of
    :func:`pivoted_cholesky_with_pivots`."""
    if block_size is None:
        block_size = settings.pivoted_cholesky_block_size.value()
    if block_size and block_size > 1 and rank > block_size:
        return _forward_only(op, lambda: _blocked_pivoted_cholesky(op, rank, error_tol, block_size))
    L, _ = pivoted_cholesky_with_pivots(op, rank, error_tol)
    return L


_FORWARD_ONLY_MESSAGE = (
    "The blocked pivoted Cholesky sweep "
    "(settings.pivoted_cholesky_block_size) is forward-only: its adaptive "
    "while_loop is not reverse-differentiable, and its pivot order differs "
    "from the reference. Unset pivoted_cholesky_block_size (or pass "
    "block_size=None) to differentiate through pivoted_cholesky."
)


class _ForwardOnly(torch.autograd.Function):
    """Runs ``build`` without autograd; the result carries the operator's
    tensors as inputs, so that a backward through it raises instead of
    silently returning no gradient."""

    @staticmethod
    def forward(ctx, build, *leaves):
        return build()

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(_FORWARD_ONLY_MESSAGE)


def _forward_only(op, build):
    return _ForwardOnly.apply(build, *op._leaves())


def pivoted_cholesky_with_pivots(op, rank: int, error_tol: float | None = None, *, diag=None, group=None,
                                 offset: int = 0, column=None):
    """(L (*b, n, rank), pivots (*b, rank)); pivot -1 marks a step taken
    after the element converged.

    Row-sharded (a model group ``group``): ``op`` is the rank's block of
    rows of K (*b, |R|, n) starting at global row ``offset``, ``diag`` K's
    diagonal on those rows, and the result is those rows of the unsharded
    factor.  Each step takes the residual diagonal's global argmax (ties to
    the lowest global index, as ``torch.argmax`` on the whole diagonal),
    with the residual trace, in one collective, and the pivot's row of L
    from its owner in another.  ``column(pivot)``, where given, returns the
    pivot's column of K on the rows (*b, |R|) in place of ``op``'s
    ``_get_indices``."""
    from ..parallel import _comm

    if error_tol is None:
        error_tol = settings.preconditioner_tolerance.value()
    settings.record_linalg("pivoted_cholesky", op.shape)

    d = op._diagonal() if diag is None else diag  # (*b, |R|)
    batch = d.shape[:-1]
    n = d.shape[-1]
    rank = min(rank, op.shape[-1])
    dtype = torch.promote_types(d.dtype, torch.float32)
    d = d.to(dtype)
    device = d.device

    row = torch.arange(n, device=device).expand(*batch, n)
    # broadcastable batch index arrays, each expanded to (*batch, n)
    batch_idx = []
    for i, b in enumerate(batch):
        shape = [1] * (len(batch) + 1)
        shape[i] = b
        batch_idx.append(torch.arange(b, device=device).reshape(shape).expand(*batch, n))

    global_row = torch.arange(n, device=device) + offset
    tol_total = None
    rows, pivots = [], []
    for _ in range(rank):
        # the residual trace rides with the argmax: sum(clamp(d, 0)) each
        # step, sum(d) (the first step's, for the tolerance) beside it
        sums = torch.stack([torch.sum(torch.clamp_min(d.detach(), 0.0), dim=-1), torch.sum(d.detach(), dim=-1)], -1)
        pivot, top, sums = _comm.argmax(d.detach(), group, offset, sums)
        dp = torch.take_along_dim(d, pivot[..., None], dim=-1)[..., 0] if group is None else top
        if tol_total is None:
            tol_total = error_tol * sums[..., 1]  # (*b,)
        active = (sums[..., 0] > tol_total) & (dp > 1e-12)

        if column is None:
            col = op._get_indices(row, pivot[..., None].expand(*batch, n), *batch_idx).to(dtype)
        else:
            col = column(pivot).to(dtype)
        if rows:
            L = torch.stack(rows, dim=-2)  # (*b, i, |R|)
            Lp = _comm.owner_row(L.mT, pivot, group, offset)  # (*b, i)
            # full precision: the downdate accumulates over rank steps
            with highest_matmul_precision():
                col = col - torch.einsum("...kn,...k->...n", L, Lp)
        li = col / torch.sqrt(torch.clamp_min(dp, 1e-30))[..., None]
        li = torch.where(active[..., None], li, 0.0)

        d = d - li * li
        # bury the chosen pivot so that it is never selected again
        d = torch.where(global_row == pivot[..., None], -torch.inf, d)
        rows.append(li)
        pivots.append(torch.where(active, pivot, -1))

    if rows:
        L = torch.stack(rows, dim=-1)
        piv = torch.stack(pivots, dim=-1).to(torch.int32)
    else:
        L = d.new_zeros((*batch, n, 0))
        piv = torch.zeros((*batch, 0), dtype=torch.int32, device=device)
    return L.to(op.dtype), piv


def _blocked_pivoted_cholesky(op, rank: int, error_tol: float | None, bs: int, threshold: float = 0.5):
    """The factor of :func:`blocked_pivoted_cholesky_with_pivots`."""
    return blocked_pivoted_cholesky_with_pivots(op, rank, error_tol, bs, threshold)[0]


def blocked_pivoted_cholesky_with_pivots(op, rank: int, error_tol: float | None, bs: int, threshold: float = 0.5,
                                         *, diag=None, group=None, offset: int = 0, column=None, pool=None):
    """Adaptive blocked greedy partial Cholesky (the JAX package's
    ``_blocked_pivoted_cholesky``), forward only: (L (n, rank), the pivots
    in the order they were accepted).

    Each sweep takes the top ``2 bs`` residual-diagonal entries as a pool
    (ties in index order, as ``lax.top_k`` takes them), forms their columns,
    runs the exact greedy recursion on the pool's small residual Gram
    (accepting a pivot while its residual is >= ``threshold`` x the pool's
    largest), and writes all accepted rows at once from one triangular
    solve.  The sweep loop runs on the host and reads one flag (and the row
    count) per sweep; the in-pool steps stay on the device.  Batched
    operators fall back to strict greedy.

    Row-sharded (a model group ``group``, as for
    :func:`pivoted_cholesky_with_pivots`): ``op`` is the rank's rows of K
    from global row ``offset``, ``diag`` their diagonal, and L the rank's
    rows of the unsharded factor, with the unsharded pivots.  A sweep makes
    one collective to choose the pool (``_comm.top``, which carries the
    stopping test's sums) and one to fetch the pool's rows of L with what
    ``pool(cand, extra)`` needs of their points, which returns K[R, cand],
    K[cand, cand] and ``extra``'s rows cand."""
    from ..parallel import _comm

    d = op._diagonal() if diag is None else diag
    if d.ndim > 1:
        return pivoted_cholesky_with_pivots(op, rank, error_tol, diag=diag, group=group, offset=offset, column=column)
    if error_tol is None:
        error_tol = settings.preconditioner_tolerance.value()
    settings.record_linalg("pivoted_cholesky_blocked", op.shape, (bs,))

    n = op.shape[-1]
    rows = d.shape[-1]
    rank = min(rank, n)
    bs = min(bs, rank)
    nc = min(2 * bs, n)  # candidate pool per sweep
    dtype = torch.promote_types(d.dtype, torch.float32)
    d = d.to(dtype).clone()
    device = d.device

    if pool is None:
        row_idx = torch.arange(rows, device=device)

        def pool(cand, extra):
            return op._get_indices(row_idx[:, None].expand(rows, nc), cand[None, :].expand(rows, nc)), None, extra[cand]

    tol_total = None
    # the factor is padded by one block so that a sweep's row write never clips
    L = torch.zeros((rank + bs, rows), dtype=dtype, device=device)
    slots = torch.arange(bs, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    pivots = []
    sweep = 0
    while sweep < rank:
        # the pool: top nc with ties in index order (a stationary kernel's
        # diagonal is all ties), the residual trace beside it
        sums = torch.stack([torch.sum(torch.clamp_min(d, 0.0)), torch.sum(d)])
        cand, top, sums = _comm.top(d, nc, group, offset, sums)
        if tol_total is None:
            tol_total = error_tol * sums[1]
        go, count_h = torch.stack([((top[0] > 1e-12) & (sums[0] > tol_total)).to(torch.int64), count]).tolist()
        if not go or count_h >= rank:
            break

        K_rc, K_cc, Lc = pool(cand, L.mT)
        Lc = Lc.mT.to(dtype)  # (rank + bs, nc): the pool's columns of L
        with highest_matmul_precision():
            C = K_rc.to(dtype) - torch.einsum("kn,kc->nc", L, Lc)
            # (nc, nc) residual Gram of the pool: its rows of the panel, or
            # where they lie on other ranks, K[cand, cand] downdated alike
            S = C[cand, :] if K_cc is None else K_cc.to(dtype) - Lc.mT @ Lc
        # the pool's residual diagonal and the sweep's scale come from the
        # fresh panel, and the tracked diagonal is synced to it (see the JAX
        # package's notes: stale tracked values can stall a sweep)
        dS = torch.diagonal(S).clone()
        d_global = torch.max(dS)
        local = cand - offset
        local = torch.where((local >= 0) & (local < rows), local, rows)  # other ranks' rows: past the end
        d = torch.cat([d, d.new_zeros(1)]).index_copy(0, local, dS)[:rows]

        T = torch.zeros((bs, nc), dtype=dtype, device=device)
        sel = torch.full((bs,), -1, dtype=torch.int64, device=device)
        k = torch.zeros((), dtype=torch.int64, device=device)
        pool_idx = torch.arange(nc, device=device)
        for _ in range(bs):
            c_rel = torch.argmax(dS)
            dp = dS[c_rel]
            accept = (count + k < rank) & (dp > 1e-12) & (dp >= threshold * d_global)
            trow = torch.where(accept, S[c_rel, :] / torch.sqrt(torch.clamp_min(dp, 1e-30)), 0.0)
            S = S - trow[:, None] * trow[None, :]
            dS = dS - trow * trow
            dS = torch.where(accept & (pool_idx == c_rel), -torch.inf, dS)
            # slot k holds zeros until accepted, so the masked write is a no-op
            T = T.index_copy(0, torch.clamp_max(k, bs - 1)[None], trow[None, :])
            sel = torch.where(accept & (slots == k), c_rel, sel)
            k = k + accept.to(k.dtype)
        valid = sel >= 0
        sel_c = torch.where(valid, sel, 0)

        # left-looking row formation: X M = G with M = triu(T[:, sel]); unused
        # slots get a unit diagonal and zero columns, so their rows are zero
        M = torch.triu(T[:, sel_c])
        M = torch.where(valid[None, :], M, 0.0) + torch.diag(torch.where(valid, 0.0, 1.0).to(dtype))
        G = torch.where(valid[None, :], C[:, sel_c], 0.0)  # (|R|, bs)
        P = torch.linalg.solve_triangular(M.mT, G.mT, upper=False)  # (bs, |R|)

        d = d - torch.sum(P * P, dim=0)
        # bury the accepted pivots; unused slots and other ranks' rows point
        # past the end, dropped
        p_loc = torch.where(valid, cand[sel_c], -1) - offset
        p_loc = torch.where((p_loc >= 0) & (p_loc < rows), p_loc, rows)
        d = torch.cat([d, d.new_zeros(1)]).index_fill(0, p_loc, -torch.inf)[:rows]

        L[count_h : count_h + bs] = P
        pivots.append(torch.where(valid, cand[sel_c], -1))
        count = count + k
        sweep += 1
    piv = torch.cat(pivots) if pivots else torch.zeros((0,), dtype=torch.int64, device=device)
    return L[:rank].mT.to(op.dtype), piv[piv >= 0][:rank].to(torch.int32)
