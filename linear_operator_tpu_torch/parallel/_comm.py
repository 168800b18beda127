"""Every collective of the port, in one module.

GSPMD inserts the JAX package's collectives; ``torch.distributed`` inserts
none, so each one the sharded solve needs is written here, explicitly:

* :func:`all_reduce`, a sum over a group;
* :func:`all_gather_rows`, row blocks of (possibly) unequal sizes gathered
  into the whole matrix, as a sum of zero-padded blocks;
* :func:`any_flags`, the global "any" of a few flags: CG's stopping test;
* :func:`broadcast`, a tensor from one rank to a group;
* :func:`argmax`, the global argmax over row blocks, ties to the lowest
  global index, with the sums a pivoted Cholesky step tests, and
  :func:`top`, the global top k so (a blocked sweep's pool);
* :func:`owner_row`, a row broadcast from the rank whose block holds it,
  and :func:`owner_rows`, several rows so;
* :func:`sum_shares`, a differentiable sum whose backward hands each rank the
  gradient of its own share;
* :func:`gather_rows`, a differentiable :func:`all_gather_rows` whose
  backward keeps the rank's rows of the cotangent, and :func:`own_rows`,
  its inverse;
* :func:`sum_grads`, the identity whose backward sums the gradients over a
  group: a replicated tensor that a rank uses for its share of a result.

Only the sum all-reduce and the broadcast are used (the argmax and the row
broadcast are sums of zero-padded tables), which both ``nccl`` and
``gloo`` take for CUDA tensors (``gloo``'s all-gather takes CPU tensors
only); an all-gather is a sum of blocks padded with exact zeros.  A group is a
:class:`Group`, or None where the axis has one rank: then nothing is sent.
``counts`` counts the calls by name, as a kernel wrapper's ``launches``
counts its launches; :func:`reset_counts` sets them to 0.
"""

from __future__ import annotations

import torch

counts: dict[str, int] = {}


def reset_counts() -> None:
    counts.clear()


def _count(name: str) -> None:
    counts[name] = counts.get(name, 0) + 1


class Group:
    """A process group and the global ranks in it, in the mesh's order; this
    rank sits at ``index``.  (Not a tuple: an operator's tuple fields are
    walked for tensors.)"""

    __slots__ = ("pg", "ranks", "index")

    def __init__(self, pg, ranks: tuple, index: int):
        self.pg, self.ranks, self.index = pg, tuple(ranks), index

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"Group(ranks={self.ranks}, index={self.index})"


def all_reduce(t: torch.Tensor, group: Group | None, name: str = "all_reduce") -> torch.Tensor:
    """The sum of ``t`` over ``group`` (``t`` itself without one), as a new
    tensor."""
    if group is None:
        return t
    import torch.distributed as dist

    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.pg)
    _count(name)
    return out


def all_gather_rows(t: torch.Tensor, group: Group | None, sizes: tuple) -> torch.Tensor:
    """The whole (..., sum(sizes), k) matrix from each rank's row block t
    (..., sizes[index], k): each rank writes its block into zeros at its
    offset and the group sums, which is exact."""
    if group is None:
        return t
    offset = sum(sizes[: group.index])
    full = torch.zeros((*t.shape[:-2], sum(sizes), t.shape[-1]), dtype=t.dtype, device=t.device)
    full[..., offset : offset + t.shape[-2], :] = t.detach()
    return all_reduce(full, group, name="all_gather")


def argmax(d: torch.Tensor, group: Group | None, offset: int, extra: torch.Tensor | None = None):
    """(index, value, extra summed) of the global maximum of a row-sharded
    (*b, |R|) array whose block starts at global row ``offset``: ties go to
    the lowest global index, as ``torch.argmax`` breaks them on the whole
    array.  Each rank writes its block's maximum, its global index and
    ``extra`` (*b, e), say partial sums, into its slot of a zero table, and
    one sum over the group hands every rank the whole table."""
    local = torch.argmax(d, dim=-1)
    value = torch.take_along_dim(d, local[..., None], dim=-1)[..., 0]
    if group is None:
        return local, value, extra
    parts = [value[..., None], (local + offset).to(d.dtype)[..., None]]
    if extra is not None:
        parts.append(extra.to(d.dtype))
    row = torch.cat(parts, dim=-1)  # (*b, 2 + e)
    table = torch.zeros((*row.shape[:-1], group.size, row.shape[-1]), dtype=d.dtype, device=d.device)
    table[..., group.index, :] = row
    table = all_reduce(table, group, name="argmax")
    # the first rank holding the largest maximum: its block's first maximum
    # is the global first maximum, the blocks being in row order
    best = torch.argmax(table[..., 0], dim=-1)
    won = torch.take_along_dim(table, best[..., None, None], dim=-2)[..., 0, :]
    total = table[..., 2:].sum(dim=-2) if extra is not None else None
    return won[..., 1].to(torch.int64), won[..., 0], total


def top(d: torch.Tensor, k: int, group: Group | None, offset: int, extra: torch.Tensor | None = None):
    """(indices (k,), values (k,), extra summed) of the ``k`` largest
    entries of a row-sharded (|R|,) array whose block starts at global row
    ``offset``, in descending order with ties to the lowest global index,
    as a stable descending sort of the whole array takes them.  Each rank
    writes its block's own top ``k`` (a rank with fewer rows pads with -inf
    at index +inf) and ``extra`` (e,) into its slot of a zero table; one sum
    over the group hands every rank the whole table, which every rank
    merges alike."""
    order = torch.sort(d, descending=True, stable=True)
    if group is None:
        return order.indices[:k], order.values[:k], extra
    have = min(k, d.shape[-1])
    values = torch.full((k,), -torch.inf, dtype=d.dtype, device=d.device)
    index = torch.full((k,), torch.inf, dtype=d.dtype, device=d.device)
    values[:have] = order.values[:have]
    index[:have] = (order.indices[:have] + offset).to(d.dtype)
    row = torch.cat([values, index] + ([] if extra is None else [extra.to(d.dtype)]))
    table = torch.zeros((group.size, row.shape[-1]), dtype=d.dtype, device=d.device)
    table[group.index] = row
    table = all_reduce(table, group, name="top")
    values, index = table[:, :k].reshape(-1), table[:, k : 2 * k].reshape(-1)
    # the whole array's order: by value, ties by global index
    by_index = torch.argsort(index, stable=True)
    chosen = by_index[torch.sort(values[by_index], descending=True, stable=True).indices[:k]]
    total = table[:, 2 * k :].sum(dim=0) if extra is not None else None
    return index[chosen].to(torch.int64), values[chosen], total


def owner_rows(rows: torch.Tensor, index: torch.Tensor, group: Group | None, offset: int,
               name: str = "owner_row") -> torch.Tensor:
    """Rows ``index`` (global, (*b, j) or (j,)) of a row-sharded (*b, |R|, k)
    array on every rank of ``group``, (*b, j, k): each row's owner writes
    it, the others zeros, and one sum over the group broadcasts them all."""
    local = index - offset
    mine = (local >= 0) & (local < rows.shape[-2])
    safe = torch.where(mine, local, 0)
    picked = torch.take_along_dim(rows, safe[..., None], dim=-2)
    if group is None:
        return picked
    return all_reduce(torch.where(mine[..., None], picked, 0.0), group, name=name)


def owner_row(rows: torch.Tensor, index: torch.Tensor, group: Group | None, offset: int) -> torch.Tensor:
    """Row ``index`` (global, (*b,)) of a row-sharded (*b, |R|, k) array on
    every rank of ``group`` (each batch element from its own owner):
    :func:`owner_rows` of one row."""
    return owner_rows(rows, index[..., None], group, offset)[..., 0, :]


def any_flags(flags: torch.Tensor, group: Group | None, name: str = "any") -> torch.Tensor:
    """Elementwise "any" of the boolean ``flags`` over ``group``: one small
    collective, read by the caller in one host transfer."""
    if group is None:
        return flags
    return all_reduce(flags.to(torch.float32), group, name=name) > 0


def broadcast(t: torch.Tensor, src: int, group: Group | None) -> None:
    """``t`` overwritten in place by its value on global rank ``src``."""
    if group is None:
        return
    import torch.distributed as dist

    dist.broadcast(t, src=src, group=group.pg)
    _count("broadcast")


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, name):
        return all_reduce(t, group, name=name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, sizes):
        ctx.offset, ctx.rows = sum(sizes[: group.index]), t.shape[-2]
        return all_gather_rows(t, group, sizes)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.offset : ctx.offset + ctx.rows, :], None, None


def gather_rows(t: torch.Tensor, group: Group | None, sizes: tuple) -> torch.Tensor:
    """:func:`all_gather_rows`, differentiable: every rank computes the same
    function of the whole matrix, so the backward hands each rank the rows
    of the cotangent that its block made."""
    if group is None:
        return t
    return _GatherRows.apply(t, group, sizes)


class _OwnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, sizes):
        ctx.group, ctx.sizes = group, sizes
        offset = sum(sizes[: group.index])
        return t[..., offset : offset + sizes[group.index], :].clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g, ctx.group, ctx.sizes), None, None


def own_rows(t: torch.Tensor, group: Group | None, sizes: tuple) -> torch.Tensor:
    """The rank's rows of a whole (..., sum(sizes), k) matrix that every
    rank of ``group`` computes alike (the Cholesky route's factor); the
    backward gathers each rank's cotangent of its rows, so that every rank
    holds the whole matrix's cotangent, the inverse of :func:`gather_rows`."""
    if group is None:
        return t
    return _OwnRows.apply(t, group, sizes)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.clone() for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        have = [g for g in gs if g is not None]
        if not have:
            return (None, *gs)
        total = all_reduce(torch.cat([g.reshape(-1) for g in have]), ctx.group, name="sum_grads")
        parts = iter(torch.split(total, [g.numel() for g in have]))
        return (None, *(None if g is None else next(parts).view_as(g) for g in gs))


def sum_grads(ts: tuple, group: Group | None) -> tuple:
    """``ts`` themselves; their backward sums each one's gradient over
    ``group`` in one collective.  A tensor replicated over the group that
    each rank uses for its own share of a result (its rows or columns) gets
    on every rank the gradient of the whole result."""
    need = [i for i, t in enumerate(ts) if t.requires_grad]
    if group is None or not need:
        return tuple(ts)
    out = list(ts)
    for i, t in zip(need, _SumGrads.apply(group, *(ts[i] for i in need))):
        out[i] = t
    return tuple(out)


def sum_shares(t: torch.Tensor, group: Group | None, name: str = "all_reduce") -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``.  Its backward passes the
    gradient to this rank's own share only, so that a loss summed so holds,
    on each rank, the gradient of that rank's share: summing those over the
    group (once, as ``sharded_train_step`` does) gives the whole gradient."""
    if group is None:
        return t
    return _SumShares.apply(t, group, name)
