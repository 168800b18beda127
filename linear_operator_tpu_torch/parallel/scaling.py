"""Throughput of the sharded GP training step (config 5) at each mesh size
(counterpart of linear_operator_tpu/parallel/scaling.py).

:func:`mll_throughput` times the forward and backward of the sharded
``neg_mll`` on a mesh, in independent GP systems per second;
:func:`scaling_report` runs it on meshes of increasing rank counts and gives
each one's efficiency against the smallest.  Ranks that share one card
measure no scaling: the efficiency means something only with a card a rank.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from .. import settings
from ..models import ExactGPRegression
from .sharding import make_mesh, shard_gp_batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mll_throughput(
    mesh,
    *,
    batch_per_device: int = 1,
    n: int = 16384,
    d: int = 3,
    num_probes: int = 10,
    block_rows: int = 4096,
    reps: int = 3,
) -> float:
    """Solves/s of the forward and backward sharded neg-MLL on this mesh:
    B = data x ``batch_per_device`` systems of n points in d dimensions
    (x ~ N(0, I) from seed 0, y = sin(3 x_0), the same on every rank, each
    keeping its block), CG + SLQ with ``num_probes`` probes, CG to 1.0 and at
    most 100 iterations, no preconditioner; the kernel streams
    (``materialize_threshold=None``), so that every mesh size runs one
    engine.  Each repetition is fenced with ``torch.cuda.synchronize()``."""
    device = mesh.device
    model = ExactGPRegression(block_rows=block_rows, materialize_threshold=None, device=device)
    B = mesh.size("data") * batch_per_device
    x = torch.randn((B, n, d), generator=torch.Generator().manual_seed(0))
    y = torch.sin(3.0 * x[..., 0])
    xs, ys = shard_gp_batch(mesh, x, y)

    def grad():
        model.zero_grad()
        with settings.max_cholesky_size(0), settings.num_trace_samples(num_probes), \
             settings.max_cg_iterations(100), settings.cg_tolerance(1.0), \
             settings.min_preconditioning_size(10**9), mesh:
            model.neg_mll(xs, ys, generator=torch.Generator().manual_seed(1)).backward()

    grad()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        grad()
        _sync(device)
    dt = (time.perf_counter() - t0) / reps
    return B / dt  # independent GP systems per second


def scaling_report(
    device_counts: Sequence[int] | None = None,
    *,
    model_axis: int = 1,
    probe_axis: int | None = None,
    device: str | torch.device = "cuda",
    **kwargs,
) -> dict:
    """Throughput and efficiency against the smallest rank count, on meshes
    of ``device_counts`` ranks (default 1, 2, 4, 8 up to the world size)
    with ``model_axis`` and ``probe_axis`` ranks on the matrix and probe
    axes.  Every rank calls it; a rank outside a mesh waits, and the report
    holds this rank's measurements."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8) if c <= world]
    results = {}
    base = None
    for c in device_counts:
        divisor = model_axis * (probe_axis or 1)
        if c % divisor:
            continue
        mesh = make_mesh(c, model=model_axis, probe=probe_axis if (probe_axis or 1) > 1 else None, device=device)
        if not mesh.active:
            continue
        thr = mll_throughput(mesh, **kwargs)
        if base is None:
            base = thr / c
        results[c] = {"solves_per_s": thr, "efficiency": thr / (base * c), "mesh": dict(mesh.shape)}
    return results
