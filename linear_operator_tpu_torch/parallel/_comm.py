"""Every collective of the port, in one module.

GSPMD inserts the JAX package's collectives; ``torch.distributed`` inserts
none, so each one the sharded solve needs is written here, explicitly:

* :func:`all_reduce`, a sum over a group;
* :func:`all_gather_rows`, row blocks of (possibly) unequal sizes gathered
  into the whole matrix, as a sum of zero-padded blocks;
* :func:`any_flags`, the global "any" of a few flags: CG's stopping test;
* :func:`broadcast`, a tensor from one rank to a group;
* :func:`sum_shares`, a differentiable sum whose backward hands each rank the
  gradient of its own share.

Only the sum all-reduce and the broadcast are used, which both ``nccl`` and
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


def any_flags(flags: torch.Tensor, group: Group | None) -> torch.Tensor:
    """Elementwise "any" of the boolean ``flags`` over ``group``: one small
    collective, read by the caller in one host transfer."""
    if group is None:
        return flags
    return all_reduce(flags.to(torch.float32), group, name="any") > 0


def broadcast(t: torch.Tensor, src: int, group: Group | None) -> None:
    """``t`` overwritten in place by its value on global rank ``src``."""
    if group is None:
        return
    import torch.distributed as dist

    dist.broadcast(t, src=src, group=group.pg)
    _count("broadcast")


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_shares(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``.  Its backward passes the
    gradient to this rank's own share only, so that a loss summed so holds,
    on each rank, the gradient of that rank's share: summing those over the
    group (once, as ``sharded_train_step`` does) gives the whole gradient."""
    if group is None:
        return t
    return _SumShares.apply(t, group)
