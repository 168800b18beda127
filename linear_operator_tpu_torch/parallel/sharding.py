"""Meshes of ranks and the sharded exact-GP step on ``torch.distributed``
(counterpart of linear_operator_tpu/parallel/sharding.py).

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here every rank runs its own block of the work and the collectives are
explicit (``_comm.py``).  A mesh lays the ranks of the process group out on
the axes

* ``data``: batches of independent GPs, split over the ranks; the loss's
  batch mean and the gradients sum over this axis;
* ``model``: the matrix dimension N, row-sharded: each rank holds rows of x
  and y, and a mat-vec gathers the vector's rows (``row_sharded.py``);
* ``probe`` (optional): the Hutchinson probes, split over the ranks; the SLQ
  sums reduce over this axis.

Ranks go row-major, as ``np.arange(used).reshape(data, model[, probe])``,
and the mesh holds one process group per slice of each axis (and of the
model-and-probe plane, and of the whole mesh).  Inside ``with mesh:``
``inv_quad_logdet`` draws the whole probe block on every rank (so that the
draws equal the unsharded ones), keeps the rank's block, and runs CG with
the global stopping test; ``ExactGPRegression.neg_mll`` row-shards its
operator over ``model`` and averages over ``data``.
"""

from __future__ import annotations

import math
import warnings
from datetime import timedelta

import numpy as np
import torch

from . import _comm
from ..solvers.linear_cg import LocalReduction

_AMBIENT: list = []


def mesh_axes(
    n_available: int,
    n_devices: int | None = None,
    data: int | None = None,
    model: int | None = None,
    probe: int | None = None,
    *,
    stacklevel: int = 2,
) -> dict:
    """The JAX package's axis arithmetic on ``n_available`` devices: the
    mesh's axes as {"data": ., "model": .[, "probe": .]}.  Missing axes come
    from the device count; an axis larger than it raises ValueError, and a
    mesh that leaves devices idle warns."""
    if n_devices is None:
        n_devices = n_available
    n_have = min(n_devices, n_available)
    axes = n_devices
    if probe is not None:
        axes //= probe
    if data is None and model is None:
        data, model = axes, 1
    elif data is None:
        data = axes // model
    elif model is None:
        model = axes // data
    # when the requested axes don't tile n_devices evenly (e.g. data=2,
    # model=2 on an 8-device host, or probe=3 on 8), use the first
    # data*model*probe devices
    used = data * model * (probe if probe is not None else 1)
    if used == 0 or used > n_have:
        axes_txt = f"data={data}, model={model}" + (f", probe={probe}" if probe is not None else "")
        raise ValueError(
            f"mesh ({axes_txt}) does not fit {n_have} devices"
            + (" (a requested axis exceeds the device count)" if used == 0 else f" (needs {used})")
        )
    if used < n_have:
        warnings.warn(
            f"make_mesh uses only {used} of {n_have} available devices "
            f"(data={data} x model={model}"
            + (f" x probe={probe}" if probe is not None else "")
            + " does not tile the device count); the rest idle. Pick axes "
            "whose product equals the device count to use all chips.",
            UserWarning,
            stacklevel=stacklevel + 1,
        )
    shape = {"data": data, "model": model}
    if probe is not None:
        shape["probe"] = probe
    return shape


def split_sizes(n: int, parts: int) -> tuple:
    """The block sizes of ``torch.tensor_split(range(n), parts)``: the first
    n % parts blocks take one more."""
    return tuple(n // parts + (1 if i < n % parts else 0) for i in range(parts))


def _part(n: int, parts: int, index: int) -> slice:
    sizes = split_sizes(n, parts)
    start = sum(sizes[:index])
    return slice(start, start + sizes[index])


class Mesh:
    """Ranks on the axes ``shape`` ({"data": D, "model": M[, "probe": P]}),
    this rank's place on them, its process groups and its device.  A rank
    outside the mesh (the mesh uses fewer ranks than the world has) has no
    place (``active`` is False).  ``with mesh:`` makes it the ambient mesh."""

    def __init__(self, shape: dict, rank: int, device: torch.device):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.ranks = np.arange(math.prod(shape.values())).reshape(tuple(shape.values()))
        self.device = device
        self.rank = rank
        where = np.argwhere(self.ranks == rank)
        self.coords = dict(zip(self.axis_names, map(int, where[0]))) if len(where) else None
        self.groups: dict = {}

    @property
    def active(self) -> bool:
        return self.coords is not None

    @property
    def devices(self) -> np.ndarray:
        """The global ranks in the mesh's layout (the JAX Mesh's ``devices``)."""
        return self.ranks

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0) if self.coords else 0

    def group(self, *axes: str) -> _comm.Group | None:
        """The group of the ranks that share this rank's place on every other
        axis (None where it has one rank): ``group("model")`` holds the
        rank's matrix rows, ``group(*mesh.axis_names)`` the whole mesh."""
        return self.groups.get(tuple(a for a in self.axis_names if a in axes))

    def _group_keys(self) -> list:
        keys = [(a,) for a in self.axis_names]
        if "probe" in self.shape:
            keys.append(("model", "probe"))
        keys.append(self.axis_names)
        return list(dict.fromkeys(keys))

    def _build_groups(self, world: int) -> None:
        """One process group per slice of each axis, made by every rank of the
        world in the same order (``dist.new_group`` is collective)."""
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            return
        for key in self._group_keys():
            idx = [self.axis_names.index(a) for a in key]
            rest = [i for i in range(self.ranks.ndim) if i not in idx]
            size = math.prod(self.shape[a] for a in key)
            if size == 1:
                continue
            for row in np.transpose(self.ranks, rest + idx).reshape(-1, size):
                ranks = tuple(int(r) for r in row)
                pg = dist.group.WORLD if len(ranks) == world else dist.new_group(list(ranks))
                if self.rank in ranks:
                    self.groups[key] = _comm.Group(pg, ranks, ranks.index(self.rank))

    def block(self, arr: torch.Tensor, *, batch: bool, rows: bool, cols: bool) -> torch.Tensor:
        """This rank's block of a global array: dim 0 over ``data`` (with
        ``batch``), dim -2 over ``model`` (``rows``), dim -1 over ``probe``
        (``cols``), each cut as ``torch.tensor_split`` cuts it."""
        index = [slice(None)] * arr.ndim
        if batch and self.size("data") > 1:
            index[0] = _part(arr.shape[0], self.size("data"), self.index("data"))
        if rows and self.size("model") > 1:
            index[-2] = _part(arr.shape[-2], self.size("model"), self.index("model"))
        if cols and self.size("probe") > 1:
            index[-1] = _part(arr.shape[-1], self.size("probe"), self.index("probe"))
        return arr[tuple(index)]

    def __enter__(self) -> "Mesh":
        if not self.active:
            raise RuntimeError(f"rank {self.rank} is not in this mesh")
        _AMBIENT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.pop()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    model: int | None = None,
    probe: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> Mesh:
    """A (data, model[, probe]) mesh over the ranks of the initialised
    process group (one process and rank 0 when none is initialised), with
    the JAX package's axis arithmetic (:func:`mesh_axes`): ``n_devices``
    ranks (default: all), missing axes computed from them.  Every rank of
    the process group calls it.  ``device`` is this rank's device: the CUDA
    device ``initialize_distributed`` set, unless the caller asks for the
    CPU."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    shape = mesh_axes(world, n_devices, data, model, probe, stacklevel=2)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh lays its mesh on CUDA devices and none is available; pass device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(shape, rank, device)
    mesh._build_groups(world)
    return mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "nccl",
    local_rank: int | None = None,
    timeout_s: float | None = None,
    **kwargs,
) -> None:
    """One call per process before any collective: a thin wrapper over
    ``torch.distributed.init_process_group`` (the JAX package's is over
    ``jax.distributed.initialize``).  ``coordinator_address`` is "host:port"
    of rank 0 (None: the ``env://`` variables), ``num_processes`` the world
    size, ``process_id`` this rank.  ``backend`` is the caller's: ``nccl``
    for the card by default, ``gloo`` where the caller names it.  Where CUDA
    is available, the rank takes ``cuda:{local_rank % device_count}``
    (``local_rank`` defaults to the rank)."""
    import torch.distributed as dist

    init_method = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)
    # unnamed, the size and rank come from the env:// variables (torchrun's)
    for key, value in (("world_size", num_processes), ("rank", process_id)):
        if value is not None:
            kwargs[key] = value
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if torch.cuda.is_available():
        if local_rank is None:
            local_rank = dist.get_rank()
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def _current_mesh() -> Mesh | None:
    """The ambient mesh of ``with mesh:`` (the JAX package's
    ``_current_physical_mesh``), or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def maybe_shard_probes(arr: torch.Tensor) -> torch.Tensor:
    """Under the ambient mesh, this rank's block of a global (batch of)
    stacked-probes/rhs array: the last (column) dim over ``probe``, the -2
    dim (the matrix N) over ``model``, the leading batch dim over ``data``,
    as the JAX package's layout constraint lays it.  Outside a mesh, ``arr``
    unchanged."""
    mesh = _current_mesh()
    if mesh is None:
        return arr
    return mesh.block(arr, batch=arr.ndim >= 3, rows=arr.ndim >= 2, cols=True)


def shard_gp_batch(mesh: Mesh, x: torch.Tensor, y: torch.Tensor):
    """This rank's block of a batch of GP data sets, x (B, n, d) and y
    (B, n): the batch over ``data`` (B a multiple of it), the rows over
    ``model`` (uneven where n is not a multiple), on the mesh's device.  One
    data set, x (n, d) and y (n,) (SKI's), splits its rows only, on a mesh
    whose data axis is 1."""
    if x.ndim == 2 and y.shape == x.shape[:1]:
        if mesh.size("data") > 1:
            raise ValueError(f"one data set does not split over data={mesh.size('data')}")
        xs, ys = shard_gp_batch(mesh, x[None], y[None])
        return xs[0], ys[0]
    if x.ndim != 3 or y.shape != x.shape[:2]:
        raise ValueError(f"shard_gp_batch takes x (B, n, d) and y (B, n), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[0] % mesh.size("data"):
        raise ValueError(f"a batch of {x.shape[0]} does not split over data={mesh.size('data')}")
    xs = mesh.block(x, batch=True, rows=True, cols=False)
    ys = mesh.block(y[..., None], batch=True, rows=True, cols=False)[..., 0]
    return xs.to(mesh.device).contiguous(), ys.to(mesh.device).contiguous()


def sharded_train_step(model, optimizer, mesh: Mesh):
    """The sharded training step of ``ExactGPRegression`` and
    ``DeepKernelGPRegression`` (and of any model whose ``neg_mll`` takes the
    rank's block): ``step(x, y, generator)`` on this rank's block of the
    data (``shard_gp_batch``) zeroes the gradients, computes the sharded
    ``neg_mll`` under the mesh and calls ``backward``, reduces the
    gradients, calls ``optimizer.step()`` and returns the loss, the same on
    every rank.

    The GP's hyperparameters leave the backward whole over ``model`` and
    ``probe`` (the operator's shares are reduced inside it), their batch's
    share over ``data``.  A model's ``row_share_parameters()`` (DKL's MLP)
    act on the rank's rows only: their gradient is the rank's share over
    ``model`` too.  One collective sums each parameter over the axes it is
    a share on: over ``data`` only where every parameter is whole on the
    model group, else over the whole mesh with each gradient counted on one
    rank of the axes it is whole on.  The parameters are broadcast from the
    mesh's first rank when the step is built, so that every rank starts
    from the same ones."""
    params = list(model.parameters())
    everyone = mesh.group(*mesh.axis_names)
    with torch.no_grad():
        for p in params:
            _comm.broadcast(p.data, 0, everyone)  # the mesh's ranks are 0, 1, ...
    shares = set()
    if mesh.size("model") > 1 and hasattr(model, "row_share_parameters"):
        shares = {id(p) for p in model.row_share_parameters()}
    if shares:
        # a row share counts once over probe, a whole parameter once over
        # model and probe; the sum over the mesh adds the rest
        first_probe = mesh.index("probe") == 0
        counted = {id(p): first_probe and (id(p) in shares or mesh.index("model") == 0) for p in params}
        group = everyone
    else:
        counted, group = {id(p): True for p in params}, mesh.group("data")

    def step(x, y, generator: torch.Generator | None = None) -> torch.Tensor:
        optimizer.zero_grad()
        with mesh:
            loss = model.neg_mll(x, y, generator=generator)
        loss.backward()
        have = [p for p in params if p.grad is not None]
        if group is not None and have:
            parts = [p.grad if counted[id(p)] else torch.zeros_like(p.grad) for p in have]
            total = _comm.all_reduce(torch.cat([g.reshape(-1) for g in parts]), group)
            for p, part in zip(have, torch.split(total, [p.grad.numel() for p in have])):
                p.grad.copy_(part.view_as(p.grad))
        optimizer.step()
        return loss.detach()

    return step


class MeshReduction(LocalReduction):
    """CG's reductions on a mesh (see ``LocalReduction``): sums over the
    matrix rows all-reduced over ``rows`` (the model group of a row-sharded
    operator), the mean residual over every column of the probe group, each
    replicated rhs column counted once (``weights`` 0 on all but one probe
    rank), and the stopping flags' "any" over the whole mesh."""

    def __init__(self, rows, probes, everyone, weights, n_columns: int, tridiag: bool):
        self.rows, self.probes, self.everyone = rows, probes, everyone
        self.weights, self.n_columns, self.tridiag = weights, n_columns, tridiag

    def norm(self, a):
        if self.rows is None:
            return super().norm(a)
        return torch.sqrt(_comm.all_reduce(torch.sum(a * a, dim=-2, keepdim=True), self.rows))

    def dot(self, a, b):
        return _comm.all_reduce(super().dot(a, b), self.rows)

    def norm_dot(self, r, z):
        if self.rows is None:
            return super().norm_dot(r, z)
        both = _comm.all_reduce(torch.stack([torch.sum(r * r, dim=-2, keepdim=True),
                                             torch.sum(r * z, dim=-2, keepdim=True)]), self.rows)
        return torch.sqrt(both[0]), both[1]

    def column_mean(self, resid):
        if self.probes is None:
            return super().column_mean(resid)
        local = torch.sum(resid[..., 0, :] * self.weights.to(resid.dtype), dim=-1)
        return _comm.all_reduce(local, self.probes) / self.n_columns

    def any(self, flags):
        return _comm.any_flags(flags, self.everyone)


class SolveLayout:
    """How ``inv_quad_logdet`` (``probes``) or ``solve`` cuts its work on the
    mesh for the operator ``op``: the global batch of the draws (dim 0 times
    the data axis) and the whole n, which of their rows (all of them unless
    ``op`` is row-sharded) and columns this rank keeps, CG's reductions, and
    the groups the SLQ sum and the operator's gradients reduce over.  A
    solve has no probe axis: its rhs's columns are whole on every probe
    rank, each rank solves them all, and the gradient shares sum over the
    model group only."""

    def __init__(self, mesh: Mesh, op, probes: bool = True):
        self.mesh = mesh
        self.row_sharded = getattr(op, "row_group", None) is not None
        batch = tuple(op.batch_shape)
        if mesh.size("data") > 1:
            if not batch:
                raise ValueError("a mesh with a data axis above 1 takes batched operators (B, n, n)")
            batch = (batch[0] * mesh.size("data"), *batch[1:])
        self.batch = batch
        self.n = op.shape[-1]
        self.rows = op.row_group if self.row_sharded else None
        # which of the operator's tensors are the rank's own rows
        self.owned = tuple(op.own_leaves()) if self.row_sharded else ()
        self.probes = mesh.group("probe") if probes else None
        # the operator's gradient shares: its rows, its probe columns
        if probes:
            self.grads = mesh.group("model", "probe") if self.row_sharded else self.probes
        else:
            self.grads = self.rows
        self.everyone = mesh.group(*mesh.axis_names)

    def block(self, arr: torch.Tensor, rows: bool = True, batch: bool = True) -> torch.Tensor:
        """The rank's block of a global (*batch, n, m) probe array (with
        ``batch`` and ``rows`` False, of one already cut to the rank's
        batch and rows: its probe columns)."""
        return self.mesh.block(arr, batch=batch and bool(self.batch), rows=rows and self.row_sharded,
                               cols=self.probes is not None)

    def draw_block(self, arr: torch.Tensor, rows: bool) -> torch.Tensor:
        """The rank's block of a whole (s, *batch, k) draw: the batch and,
        with ``rows``, the last dim as the operator's rows."""
        return self.mesh.block(arr.movedim(0, -1), batch=bool(self.batch), rows=rows and self.row_sharded,
                               cols=False).movedim(-1, 0)

    def norm(self, arr: torch.Tensor) -> torch.Tensor:
        """The columns' norms (*b, 1, m) of a (*b, |R|, m) block of rows."""
        return torch.sqrt(self.row_sum(torch.sum(arr * arr, dim=-2, keepdim=True)))

    def keeps_rhs(self) -> bool:
        """Whether this rank's share of a replicated rhs column counts: on one
        rank of the probe group only (on every rank of a solve)."""
        return self.probes is None or self.mesh.index("probe") == 0

    def reduction(self, m_local: int, m: int, n_rhs: int, ref: torch.Tensor) -> MeshReduction:
        weights = torch.ones(m_local + n_rhs, device=ref.device)
        if not self.keeps_rhs():
            weights[m_local:] = 0.0
        return MeshReduction(self.rows, self.probes, self.everyone, weights, m + n_rhs, tridiag=m > 0)

    def probe_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _comm.all_reduce(t, self.probes)

    def row_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _comm.all_reduce(t, self.rows)

    def reduce_grads(self, grads: tuple) -> tuple:
        """The operator's gradient shares summed over its rows (and probe
        columns), in one collective.  The rank's own rows (``owned``: x_R,
        W_R's stencils) are another rank's nowhere: their gradients are
        summed over the probe columns only (a second collective, where a
        probe axis splits them), never over the rows."""
        own = [bool(self.owned) and self.owned[i] for i in range(len(grads))]
        shared = _sum([None if o else g for g, o in zip(grads, own)], self.grads)
        mine = _sum([g if o else None for g, o in zip(grads, own)], self.probes)
        return tuple(m if o else s for s, m, o in zip(shared, mine, own))


def _sum(grads: list, group) -> list:
    """Each gradient (None: none) summed over ``group`` in one collective."""
    have = [g for g in grads if g is not None]
    if group is None or not have:
        return grads
    total = _comm.all_reduce(torch.cat([g.reshape(-1) for g in have]), group)
    parts = iter(torch.split(total, [g.numel() for g in have]))
    return [None if g is None else next(parts).view_as(g) for g in grads]


def solve_layout(op) -> SolveLayout | None:
    """The layout of a ``solve`` (and of a Lanczos start) with ``op``: a
    row-sharded operator's, on the mesh it was built on; a batched
    operator's under an ambient mesh whose data axis splits its batch; else
    None, and the solve runs as it does unsharded."""
    if getattr(op, "row_group", None) is not None:
        return SolveLayout(op.mesh, op, probes=False)
    mesh = _current_mesh()
    if mesh is None or mesh.size("data") == 1 or not op.batch_shape:
        return None
    return SolveLayout(mesh, op, probes=False)
