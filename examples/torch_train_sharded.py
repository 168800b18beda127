"""Multi-GPU GP training over a (data, model, probe) mesh of ranks with the
PyTorch/CUDA port, as ``examples/train_sharded.py`` trains the JAX package
over a device mesh: a batch of GP systems split over ``data``, each
system's matrix dimension N row-sharded over ``model`` (a mat-vec gathers
the vector's rows; CG's inner products sum over the rows), the Hutchinson
probes over ``probe``.  ``torch.distributed`` inserts no collective of its
own: the port's ``parallel/`` makes each one.

Under torchrun, one rank a GPU (any world size):

    torchrun --nproc-per-node 4 examples/torch_train_sharded.py

as one rank when run plainly, and on the CPU with ``--device cpu`` (gloo):

    python examples/torch_train_sharded.py --device cpu --steps 3 --n 128

Each rank joins the process group through ``initialize_distributed`` (the
``env://`` variables torchrun sets, else a one-rank group on a free local
port).  The mesh's axes follow the JAX example's: model 2 on an even world,
probe 2 on a multiple of 4.  The last line of rank 0's output is a JSON
summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys
import time

import torch

# python puts the SCRIPT's dir (examples/) on sys.path, not the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import linear_operator_tpu_torch as lo  # noqa: E402
from linear_operator_tpu_torch import settings  # noqa: E402
from linear_operator_tpu_torch.parallel import (  # noqa: E402
    initialize_distributed,
    make_mesh,
    shard_gp_batch,
    sharded_train_step,
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--n", type=int, default=1024, help="points a system on each rank of the model axis")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="nccl on the card, gloo on the CPU (the default)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    import torch.distributed as dist

    started_here = not dist.is_initialized()
    if started_here:
        if "WORLD_SIZE" in os.environ:
            initialize_distributed(backend=backend, local_rank=int(os.environ.get("LOCAL_RANK", 0)))
        else:
            initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend=backend)
    torch.backends.cuda.matmul.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    model_axis = 2 if world % 2 == 0 else 1
    probe_axis = 2 if world % 4 == 0 else None
    mesh = make_mesh(world, model=model_axis, probe=probe_axis, device=device)
    if rank == 0:
        print(f"ranks: {world}, mesh axes: {mesh.shape}, backend {backend}, device {mesh.device}")

    # a batch of B independent GP systems (the data axis), drawn alike on
    # every rank, each rank keeping its block
    B, n, d = mesh.size("data") * 2, args.n * model_axis, 3
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, n, d), dtype=torch.float32, generator=g)
    y = torch.sin(3.0 * x[..., 0]) + 0.1 * torch.randn((B, n), dtype=torch.float32, generator=g)
    xs, ys = shard_gp_batch(mesh, x, y)

    model = lo.ExactGPRegression(block_rows=min(n, 4096), device=mesh.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=5e-2)
    step = sharded_train_step(model, optimizer, mesh)
    losses = []
    with settings.max_cholesky_size(0), settings.num_trace_samples(8), settings.max_cg_iterations(60), \
            settings.cg_tolerance(1e-4), settings.min_preconditioning_size(10**9):
        t0 = time.perf_counter()
        for it in range(args.steps):
            loss = step(xs, ys, generator=torch.Generator(device=mesh.device).manual_seed(it))
            losses.append(float(loss))
            if rank == 0 and (it % 5 == 0 or it == args.steps - 1):
                print(f"step {it:3d}  loss {losses[-1]:.5f}")
        dt = time.perf_counter() - t0
    out = dict(example="torch_train_sharded", world=world, mesh=mesh.shape, loss=[losses[0], losses[-1]],
               finite=all(map(math.isfinite, losses)), steps_per_s=args.steps / dt)
    if rank == 0:
        print(f"{args.steps} sharded steps in {dt:.1f}s ({args.steps * B / dt:.1f} GP-systems-steps/s)")
        print(json.dumps(out))
    if started_here:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
