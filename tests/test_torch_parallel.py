"""The port's ``parallel/`` against the JAX package's, on the CPU.

The mesh arithmetic (``make_mesh``'s axes, its warning and its ValueError)
is held against the JAX ``make_mesh`` on the 8 fake devices of
``conftest.py``, over the argument mixes of the JAX package's own tests.

The sharded exact-GP step runs in two gloo worlds of processes
(``torch_parallel_worker.py``), one of 2 ranks and one of 4, spawned
together: the layouts (data 2, model 1) and (data 1, model 2) in the first,
(data 2, model 2) and (data 1, model 2, probe 2) in the second, each at
B = 8 and n = 32 and at n = 33 (uneven row blocks), in float64 on the
blocked path, with the settings of ``tests/test_models_parallel.py`` and
one probe block for both packages.  Each rank's loss and gradient (its
shares summed over ``data``, as the training step sums them) are held
against the JAX package's unsharded ``jax.value_and_grad``; its CG iteration
count against the unsharded run's; one ``sharded_train_step`` with Adam
against Adam's first step on the JAX gradient.  The float32 fused route
(the kernels' plain versions) is held against the unsharded port, and the
collectives and kernel routes are counted.

The serving runs (``SERVE`` in the worker) take every layout at n = 32 and
33 with B = 2: neg_mll and its gradient under the pivoted (rank 5), Nystrom
(rank 8) and auto preconditioners (from n = 16) and on the Cholesky route,
solve and its gradients, the posterior (and its gradient against the
unsharded port's), and the LOVE cache's predictions, each against the JAX
package's unsharded function in one jitted call a size; on the row-sharded
layouts the collectives by name.  They lie 2.8e-11 (losses), 5.3e-9
(gradients, the pivoted case), 5.7e-11 (the posterior) and 6.3e-11 (the
cache's mean) from the JAX package, and are held to the step's 2e-9 and
3e-7.

The SKI, DKL and trainable-x runs, in the same worlds: SKI (TestShardedSKI's data, grid (16, 8)),
linear on model 2 and 4 at n = 513 (uneven rows) and cubic on model 4 at
n = 512, under TestShardedSKI's settings, pivoted rank 5, Nystrom rank 8
and the Cholesky route, and its LOVE posterior, against the JAX package's
unsharded SKIGPRegression on the same draws (SKI_RTOL where CG stops
unconverged), with the collectives by name: one "interp" sum a mat-vec, no
gathered vector; DKL (d_in 3, hidden (8, 2), B = 2) on (1, 2), (2, 2) and
(1, 2, 2): the loss and every gradient after sharded_train_step's one sum
over the mesh against the JAX package's, and two steps against unsharded
Adam; and each f64 exact-GP run's gradient in a trainable x, the rank's rows
of the JAX gradient.

The roots' runs, on the serve runs of (1, 2) at n = 32 and 33 and of (2, 2)
and (1, 2, 2) at n = 33 (ROOTS in the worker): posterior_distribution (mean,
covariance, draws, log_prob, and the gradient through the inverse root), the
forward root, the inverse root and the Cholesky route's root with their
gradients, diagonalization, the root's draws and the blocked pivoted sweep
(rank 24, block 8), each against the JAX package's unsharded function on the
same draws, with the collectives each makes; SKI's gradient in x through
the interpolation weights on every SKI run.

Tolerances (measured): the unsharded port lies 7.2e-10 (the loss) and
7.2e-8 (the gradient, of its norm) from the JAX package at n = 32: 21 CG
iterations, 20 of them building the SLQ tridiagonals, which lose
orthogonality on a 32 x 32 system, carry the two packages' summation orders
that far.  A data-only mesh changes no sum (the sharded port equals the
unsharded one), and row sharding, which splits every sum over the rows in
two, lands within that distance (7.1e-10 and 7.5e-9).  So the loss is held
to 2e-9 and the gradient to 3e-7 of its norm; the float32 fused route to
1e-6 of the unsharded port (measured 0 and 6e-8).
"""

import concurrent.futures
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu.parallel as jpar
import linear_operator_tpu_torch.parallel as tpar
from linear_operator_tpu.models import ExactGPRegression as JaxGP
from linear_operator_tpu.solvers.pivoted_cholesky import _blocked_pivoted_cholesky as jsolvers_blocked
from linear_operator_tpu_torch.parallel.sharding import Mesh, mesh_axes, shard_gp_batch, split_sizes
from linear_operator_tpu_torch.test.utils import local_device_mesh
from test_torch_harness_common import _jit, one_torch_thread  # noqa: F401 (an autouse fixture)

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
sys.path.insert(0, str(WORKER.parent))
from torch_parallel_worker import (  # noqa: E402 (the cases' settings)
    ALGEBRA,
    BLOCK_RANK,
    BLOCK_SIZE,
    CIQ,
    DKL_HIDDEN,
    ROOTS,
    ROOTS_CHOLESKY,
    SAMPLES,
    SERVE,
    SKI_CASES,
    SKI_X_GRAD,
    ski_index,
)

WORLDS = {2: [(2, 1, None), (1, 2, None)], 4: [(2, 2, None), (1, 2, 2)]}
# SKI (TestShardedSKI's data: n = 512, grid (16, 8), and n = 513, whose
# rows split unevenly): (interp, layout, n) in each world; DKL (B = 2,
# d_in = 3) on each layout
SKI_RUNS = {2: [("linear", (1, 2, None), 513)],
            4: [("linear", (1, 4, None), 513), ("cubic", (1, 4, None), 512)]}
SKI_SIZES, SKI_GRID, SKI_M = (512, 513), (16, 8), 5
DKL_RUNS = {2: [(1, 2, None)], 4: [(2, 2, None), (1, 2, 2)]}
DKL_B, DKL_D = 2, 3
SKI_STENCIL = {"linear": 4, "cubic": 16}  # points a stencil: 2^D, 4^D
# SKI's holds against the JAX package (loss, gradient of its norm) where CG
# stops unconverged: under TestShardedSKI's settings (no preconditioner, 30
# iterations to 1e-6 at noise 0.127) every reordering of a sum moves the
# result: the unsharded port lies 1.2e-6 and 3.9e-7 from the JAX package,
# the sharded port up to 8.2e-7 and 3.3e-7 from the unsharded port, and up
# to 1.2e-6 and 3.9e-7 from the JAX package; under the pivoted
# preconditioner (rank 5) 2.2e-8 and 1.0e-8.  Nystrom and the Cholesky
# route lie within 1e-11 and take LOSS_RTOL and GRAD_RTOL
SKI_RTOL = {"cg": (5e-6, 1.5e-6), "pivoted": (1e-7, 5e-8)}
# the algebra runs: indexing on (1, 2) (with the algebra and CIQ) and on
# (1, 4), whose row selections span every rank, at n = 33 (uneven rows)
ALGEBRA_RUNS = {2: (1, 2, None, "full"), 4: (1, 4, None, "index")}
ALGEBRA_N, ALGEBRA_M = 33, 3
INDEX_CASES = ("rows", "square", "rect", "cols", "colslice", "batch", "entries")
ALGEBRA_CASES = ("low_rank", "root_low_rank", "sum_op", "sum_dense", "sum_scalar", "mul", "scaled", "expand", "cat",
                 "cat_root")
# f64 holds of the algebra (of the largest entry; gradients of their norm),
# and of CIQ on the blocked path (test_torch_ciq.py's CASES)
ALGEBRA_RTOL, ALGEBRA_GRAD_RTOL, CIQ_RTOL = 1e-9, 1e-6, 1e-6
SIZES = (32, 33)
B, D, PROBES = 8, 2, 4
SERVE_B, SERVE_M = 2, 5
PARAMS = (-0.3, 0.1, -1.5)  # raw lengthscale, outputscale, noise
SETTINGS = dict(max_cholesky_size=0, num_trace_samples=PROBES, max_cg_iterations=30, cg_tolerance=1e-6,
                min_preconditioning_size=10**9)
LOSS_RTOL, GRAD_RTOL, FUSED_RTOL, SERVE_RTOL = 2e-9, 3e-7, 1e-6, 2e-9
LR, ADAM_EPS = 0.01, 1e-8
TIMEOUT_S = 120
REF_PROCESSES = 2  # the processes that compute the JAX references


# ---------------------------------------------------------------------------
# The mesh arithmetic
# ---------------------------------------------------------------------------

# (n_devices, data, model, probe): the mixes of tests/test_round5_fixes.py:82-95,
# tests/test_reference_sweep.py:642-719, tests/test_round3_fixes.py:198-200,
# test_models_parallel.py and the bench (bench.py:341-354), and the defaults
MESH_ARGS = [
    (4, 2, 2, None), (None, 3, None, None), (None, 2, 2, None), (None, None, None, 3), (None, None, 16, None),
    (8, 2, 2, 2), (8, None, 1, None), (8, None, 2, None), (8, None, 2, 2), (None, None, None, None),
    (8, None, 2, 4), (2, None, 2, None), (1, None, 1, None), (8, 2, None, None), (6, None, 2, None),
    (16, None, 2, None), (8, 4, 4, None), (8, None, None, 8),
]


def _outcome(fn):
    """(shape, warning messages, error message) of one call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            shape = fn()
        except ValueError as err:
            return None, [], str(err)
    return shape, [str(w.message) for w in caught if issubclass(w.category, UserWarning)], None


@pytest.mark.parametrize("n_devices, data, model, probe", MESH_ARGS)
def test_mesh_axes_match_jax(n_devices, data, model, probe):
    def jax_mesh():
        mesh = jpar.make_mesh(n_devices, data=data, model=model, probe=probe)
        assert mesh.devices.shape == tuple(mesh.shape.values())
        return dict(mesh.shape)

    assert len(jax.devices()) == 8
    want = _outcome(jax_mesh)
    got = _outcome(lambda: mesh_axes(8, n_devices, data, model, probe))
    assert got == want


def test_make_mesh_on_one_process():
    """Without a process group, make_mesh lays one rank (rank 0), the JAX
    package's single-device mesh; more raises as the arithmetic does."""
    mesh = tpar.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.active and mesh.devices.shape == (1, 1)
    assert tpar.make_mesh(1, probe=1, device="cpu").shape == {"data": 1, "model": 1, "probe": 1}
    with pytest.raises(ValueError, match="does not fit 1 devices"):
        tpar.make_mesh(2, device="cpu")
    with local_device_mesh(device="cpu") as ambient:
        assert tpar.sharding._current_mesh() is ambient
    assert tpar.sharding._current_mesh() is None


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2}, {"data": 1, "model": 2, "probe": 2},
                                   {"data": 2, "model": 1, "probe": 2}, {"data": 4, "model": 1}])
@pytest.mark.parametrize("n", [32, 33])
def test_blocks_tile_the_global_arrays(shape, n):
    """Each rank's blocks (shard_gp_batch, maybe_shard_probes) are the
    tensor_split blocks of its place, ranks row-major: over all ranks the
    probe blocks tile the global array once, the data blocks once per probe
    rank.  Outside a mesh maybe_shard_probes returns its argument."""
    x = torch.arange(8 * n * 3, dtype=torch.float64).reshape(8, n, 3)
    probes = torch.arange(8 * n * 5, dtype=torch.float64).reshape(8, n, 5)
    assert tpar.maybe_shard_probes(probes) is probes
    seen_x, seen_p = torch.zeros_like(x), torch.zeros_like(probes)
    ranks = np.arange(int(np.prod(list(shape.values())))).reshape(tuple(shape.values()))
    for rank in ranks.flat:
        mesh = Mesh(shape, int(rank), torch.device("cpu"))
        assert tuple(np.argwhere(ranks == rank)[0]) == tuple(mesh.index(a) for a in shape)
        xs, ys = shard_gp_batch(mesh, x, x[..., 0])
        assert torch.equal(ys, xs[..., 0])
        b = torch.tensor_split(torch.arange(8), shape["data"])[mesh.index("data")]
        r = torch.tensor_split(torch.arange(n), shape["model"])[mesh.index("model")]
        c = torch.tensor_split(torch.arange(5), shape.get("probe", 1))[mesh.index("probe")]
        seen_x[b[:, None], r[None, :]] += xs
        with mesh:
            seen_p[b[:, None, None], r[None, :, None], c[None, None, :]] += tpar.maybe_shard_probes(probes)
    assert torch.equal(seen_x, x * shape.get("probe", 1)) and torch.equal(seen_p, probes)


def test_parallel_exports_the_jax_names():
    assert tpar.__all__ == jpar.__all__
    assert all(callable(getattr(tpar, name)) for name in tpar.__all__)


# ---------------------------------------------------------------------------
# The sharded step in gloo worlds
# ---------------------------------------------------------------------------


def _data(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(B, n, D))
    return x, np.sin(3.0 * x[..., 0]), rng.normal(size=(B, n, PROBES))


def _serve_data(n):
    """A serving data set of SERVE_B systems: x, y, the query points, a
    solve's rhs and its weights, and the draws of both packages by shape
    (the preconditioners' eps1 at each rank and eps2, the Lanczos start)."""
    rng = np.random.default_rng(100 + n)
    x = rng.normal(size=(SERVE_B, n, D))
    arrays = dict(x=x, y=np.sin(3.0 * x[..., 0]), x_star=rng.normal(size=(SERVE_B, SERVE_M, D)),
                  rhs=rng.normal(size=(SERVE_B, n, 3)), w=rng.normal(size=(SERVE_B, n, 3)))
    for shape in {(PROBES, SERVE_B, 5), (PROBES, SERVE_B, 8), (PROBES, SERVE_B, n), (SERVE_B, n)}:
        arrays["draw" + "x".join(map(str, shape))] = rng.normal(size=shape)
    # the roots' runs: a value for log_prob, and the draws' z (a root of
    # the training set's k = n columns, the m x m Cholesky factor's m)
    arrays["y_star"] = rng.normal(size=(SERVE_B, SERVE_M))
    arrays["iv"] = rng.normal(size=(SERVE_B, n, 2))  # the inverse root's start vectors
    for shape in ((SERVE_B, n, SAMPLES), (SERVE_B, SERVE_M, SAMPLES)):
        arrays["draw" + "x".join(map(str, shape))] = rng.normal(size=shape)
    return arrays


def _ski_data(n):
    """TestShardedSKI's data set at n points (x ~ U[0, 1]^2), its grid and
    parameters (the JAX model's initial ones), query points, and the draws
    of both packages by shape: the probes, the preconditioners' eps1 and
    eps2 and the Lanczos start."""
    rng = np.random.default_rng(200 + n)
    x = rng.uniform(size=(n, 2))
    grid = jlo.models.make_grid(jnp.asarray(x), SKI_GRID)
    arrays = dict(x=x, y=np.sin(5.0 * x[:, 0]) * np.cos(3.0 * x[:, 1]), x_star=rng.uniform(size=(SKI_M, 2)),
                  mins=np.asarray(grid.mins), maxs=np.asarray(grid.maxs), sizes=np.array(SKI_GRID),
                  ls=np.zeros(2), params=np.array([0.0, 0.0, -2.0]))
    for shape in {(n, PROBES), (PROBES, 5), (PROBES, 8), (PROBES, n), (n,)}:
        arrays["draw" + "x".join(map(str, shape))] = rng.normal(size=shape)
    arrays[f"draw{PROBES}x24"] = rng.normal(size=(PROBES, 24))  # the blocked sweep's eps1
    return arrays


def _dkl_data(n):
    """A DKL data set of DKL_B systems (x (B, n, d_in)), the JAX model's
    initial MLP, the GP head's parameters and the probes."""
    rng = np.random.default_rng(300 + n)
    x = rng.normal(size=(DKL_B, n, DKL_D))
    mlp = jlo.models.init_mlp(jax.random.PRNGKey(3), (DKL_D, *DKL_HIDDEN), dtype=jnp.float64)
    arrays = dict(x=x, y=np.sin(3.0 * np.tanh(x @ np.linspace(-1.0, 1.0, DKL_D))), params=np.array(PARAMS),
                  draw=rng.normal(size=(DKL_B, n, PROBES)))
    arrays.update({f"w{i}": np.asarray(w) for i, w in enumerate(mlp.weights)})
    arrays.update({f"b{i}": np.asarray(b) for i, b in enumerate(mlp.biases)})
    return arrays


def _runs():
    runs = {world: [] for world in WORLDS}
    for world, (data, model, probe, kind) in ALGEBRA_RUNS.items():
        runs[world].append(dict(name=f"algebra-{data}x{model}-n{ALGEBRA_N}", layout=[data, model, probe],
                                case=f"a{ALGEBRA_N}", algebra=kind))
    for world, cases in SKI_RUNS.items():
        for interp, layout, n in cases:
            tag = "x".join(str(a) for a in layout if a is not None)
            runs[world].append(dict(name=f"ski-{interp}-{tag}-n{n}", layout=list(layout), case=f"ski{n}",
                                    interp=interp, ski=True))
    for world, layouts in DKL_RUNS.items():
        for layout in layouts:
            tag = "x".join(str(a) for a in layout if a is not None)
            for n in SIZES:
                runs[world].append(dict(name=f"dkl-{tag}-n{n}", layout=list(layout), case=f"dkl{n}", dkl=True))
    for world, layouts in WORLDS.items():
        for layout in layouts:
            tag = "x".join(str(a) for a in layout if a is not None)
            for n in SIZES:
                runs[world].append(dict(name=f"{tag}-n{n}", layout=list(layout), case=f"n{n}", dtype="float64",
                                        fused=False, raises=layout[1] > 1 and n == SIZES[0]))
            runs[world].append(dict(name=f"{tag}-fused", layout=list(layout), case=f"n{SIZES[0]}",
                                    dtype="float32", fused=True))
            for n in SIZES:
                # the roots' runs: on (1, 2) at both sizes, on the world of
                # 4's meshes at the uneven one
                runs[world].append(dict(name=f"{tag}-serve-n{n}", layout=list(layout), case=f"s{n}",
                                        dtype="float64", fused=False, serve=True,
                                        roots=layout[1] > 1 and (world == 2 or n == SIZES[1])))
    return runs


def _algebra_data(n):
    """An algebra data set of SERVE_B systems: x, y, a product's and a
    solve's vectors w (and w_cat, of the n + m appended rows), a low-rank V,
    a symmetric dense A, m new points, row and column indices spanning the
    ranks, batch indices, and the draws of both packages by shape (the
    Lanczos start, CIQ's base)."""
    rng = np.random.default_rng(400 + n)
    x = rng.normal(size=(SERVE_B, n, D))
    a = rng.normal(size=(SERVE_B, n, n)) / n
    arrays = dict(x=x, y=np.sin(3.0 * x[..., 0]), w=rng.normal(size=(SERVE_B, n, 3)),
                  V=rng.normal(size=(SERVE_B, n, 2)) / 3.0, A=a + np.swapaxes(a, -1, -2),
                  x_new=rng.normal(size=(SERVE_B, ALGEBRA_M, D)), w_cat=rng.normal(size=(SERVE_B, n + ALGEBRA_M, 3)),
                  idx=np.array([0, n - 1, 5, 17, 3, n // 2 + 1]), idx2=np.array([4, 4, n - 2, 0, 9, 30]),
                  bidx=np.array([1, 0, 1, 1, 0, 0]), params=np.array(PARAMS))
    for shape in {(SERVE_B, n), (SERVE_B, n, SAMPLES)}:
        arrays["draw" + "x".join(map(str, shape))] = rng.normal(size=shape)
    return arrays


def _jax_algebra(n):
    """The JAX package's unsharded results of the algebra runs (the worker's
    ``_algebra``) on the same data and draws, in one jitted function: each
    indexed block's values and product, the pointwise entries; each sum's,
    add_low_rank's, mul's, the constant multiple's, the batch expansion's
    and cat_rows's values and product, with the solves' rows and the
    gradients of sum(w * solve); sqrt_inv_matmul and the gradients of
    sum(V_0 * out) with and without the preconditioner; CIQ's draws."""
    arrays = _algebra_data(n)
    x, w, V, A, x_new, w_cat = (jnp.asarray(arrays[k]) for k in ("x", "w", "V", "A", "x_new", "w_cat"))
    idx, idx2, bidx = (arrays[k] for k in ("idx", "idx2", "bidx"))
    draws = {v.shape: v for k, v in arrays.items() if k.startswith("draw")}
    model = JaxGP(block_rows=32, materialize_threshold=None)
    per_system = (SERVE_B, 1, 1)
    params = model.init_params(D, dtype=jnp.float64)._replace(
        raw_lengthscale=jnp.full(per_system, PARAMS[0], jnp.float64),
        raw_outputscale=jnp.full(per_system, PARAMS[1], jnp.float64),
        raw_noise=jnp.asarray(PARAMS[2], jnp.float64))
    key = jax.random.PRNGKey(0)

    def appended(p):
        K = model.train_operator(p, x)
        C = model.covariance(p, x_new).to_dense() + jax.nn.softplus(p.raw_noise) * jnp.eye(ALGEBRA_M)
        return K.cat_rows(model.covariance(p, x_new, x).to_dense(), C)

    ops = {
        "low_rank": (lambda p: model.train_operator(p, x).add_low_rank(V), w),
        "sum_op": (lambda p: model.train_operator(p, x) + model.covariance(p, x), w),
        "sum_dense": (lambda p: model.train_operator(p, x) + A, w),
        # the JAX AddedDiag takes no scalar summand: the same values as a tensor
        "sum_scalar": (lambda p: model.train_operator(p, x) + jnp.full((SERVE_B, n, n), 0.5), w),
        "mul": (lambda p: model.train_operator(p, x).mul(model.covariance(p, x)), w),
        "scaled": (lambda p: model.train_operator(p, x) * 2.5 - model.train_operator(p, x), w),
        "expand": (lambda p: model.train_operator(p, x)._expand_batch((3, SERVE_B)), w),
        "cat": (appended, w_cat),
    }

    def everything(p, z):
        out = {}
        K = model.train_operator(p, x)
        for case, block, v in (("rows", K[..., idx, :], w), ("square", K[..., 2:20, 2:20], w[..., 2:20, :]),
                               ("rect", K[..., 2:20, 5:30], w[..., 5:30, :]), ("cols", K[..., :, idx], w[..., idx, :]),
                               ("colslice", K[..., :, 3:11], w[..., 3:11, :])):
            out[case] = dict(dense=block.to_dense(), mv=block @ v)
        out["batch"] = dict(dense=K[-1].to_dense())
        out["entries"] = dict(pairs=K[..., idx, idx2], batched=K[bidx, idx, idx2])
        for case, (make, v) in ops.items():
            op = make(p)
            out[case] = dict(dense=op.to_dense(), mv=op @ v)
        for case in ("low_rank", "sum_op", "cat"):
            make, v = ops[case]

            def loss(q, make=make, v=v):
                sol = make(q).solve(v)
                return jnp.sum(sol * v), sol

            (_, sol), g = jax.value_and_grad(loss, has_aux=True)(p)
            out[case].update(sol=sol, grads=g)
        for label, over in CIQ.items():
            def ciq():
                # the backward reads the MINRES settings too
                got, vjp = jax.vjp(lambda q, zz: jlo.sqrt_inv_matmul(model.train_operator(q, x), zz, key=key), p, z)
                g, z_grad = vjp(jnp.broadcast_to(V[..., :1], got.shape))
                return dict(out=got, z_grad=z_grad, grads=g)

            out[f"ciq_{label}"] = _under({**SETTINGS, **ALGEBRA, **over}, ciq)
        def samples():
            def squares(q):
                s = model.train_operator(q, x).zero_mean_mvn_samples(SAMPLES, key=key)
                return jnp.sum(s * s), s

            (_, s), g = jax.value_and_grad(squares, has_aux=True)(p)
            return dict(samples=s, grads=g)

        out["ciq_samples"] = _under({**SETTINGS, **ALGEBRA, **CIQ["precond"], "ciq_samples": True}, samples)
        return out

    res = _with_draws(draws, lambda: _under({**SETTINGS, **ALGEBRA}, lambda: _jit(everything)(params, w)))

    def grads(g):
        return np.array([float(jnp.sum(g.raw_lengthscale)), float(jnp.sum(g.raw_outputscale)), float(g.raw_noise)])

    out = {}
    for case, got in res.items():
        out[case] = {k: grads(v) if k == "grads" else np.asarray(v) for k, v in got.items()}
    for case, same in (("root_low_rank", "low_rank"), ("cat_root", "cat")):
        out[case] = dict(dense=out[same]["dense"], mv=out[same]["mv"])
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_reference(n):
    """The JAX package's unsharded loss, its gradient and its gradient in x
    on the same probes."""
    x, y, probes = _data(n)
    model = JaxGP(block_rows=32, materialize_threshold=None)
    params = model.init_params(D, dtype=jnp.float64)._replace(
        **{name: jnp.asarray(v, jnp.float64) for name, v in zip(("raw_lengthscale", "raw_outputscale",
                                                                 "raw_noise"), PARAMS)})
    normal = jax.random.normal

    def draw(key, shape=(), dtype=jnp.float64):
        assert tuple(shape) == probes.shape
        return jnp.asarray(probes, dtype)

    def loss_in(p, xx):
        ctxs = [getattr(jlo.settings, k)(v) for k, v in SETTINGS.items()]
        for c in ctxs:
            c.__enter__()
        try:
            return model.neg_mll(p, xx, jnp.asarray(y), key=jax.random.PRNGKey(7))
        finally:
            for c in reversed(ctxs):
                c.__exit__(None, None, None)

    jax.random.normal = draw
    try:
        value, (grads, x_grad) = _jit(jax.value_and_grad(loss_in, argnums=(0, 1)))(params, jnp.asarray(x))
    finally:
        jax.random.normal = normal
    return float(value), np.array([float(grads.raw_lengthscale), float(grads.raw_outputscale),
                                   float(grads.raw_noise)]), np.asarray(x_grad)


def _jax_serving(n):
    """The JAX package's unsharded results of the serving cases (SERVE) on
    the same data and draws, in one jitted function: each neg_mll and its
    gradient, the solve's loss sum(solve(K, rhs) * w) and its gradients in
    the parameters and the rhs, the posterior, and the LOVE cache's
    predictions."""
    arrays = _serve_data(n)
    x, y, x_star, rhs, w = (jnp.asarray(arrays[k]) for k in ("x", "y", "x_star", "rhs", "w"))
    draws = {v.shape: v for k, v in arrays.items() if k.startswith("draw")}
    model = JaxGP(block_rows=32, materialize_threshold=None)
    # the lengthscale and outputscale as one (1, 1) copy a system: the JAX
    # package's pivoted Cholesky takes no batched kernel operator with 0-d
    # hyperparameters (its _index_param, which the port repaired); the
    # gradients are the copies' sums
    per_system = (SERVE_B, 1, 1)
    params = model.init_params(D, dtype=jnp.float64)._replace(
        raw_lengthscale=jnp.full(per_system, PARAMS[0], jnp.float64),
        raw_outputscale=jnp.full(per_system, PARAMS[1], jnp.float64),
        raw_noise=jnp.asarray(PARAMS[2], jnp.float64))
    normal = jax.random.normal

    def draw(key, shape=(), dtype=jnp.float64):
        return jnp.asarray(draws[tuple(shape)], dtype)

    def under(case, fn):
        over = {**SETTINGS, **SERVE[case]}
        ctxs = [getattr(jlo.settings, k)(v) for k, v in over.items()]
        for c in ctxs:
            c.__enter__()
        try:
            return fn()
        finally:
            for c in reversed(ctxs):
                c.__exit__(None, None, None)

    key = jax.random.PRNGKey(7)

    def everything(p, rhs):
        out = {}
        for case in ("pivoted", "nystrom", "auto", "cholesky"):
            out[case] = jax.value_and_grad(lambda q, case=case: under(case, lambda: model.neg_mll(q, x, y, key=key)))(p)

        def solve_loss(q, r):
            return under("solve", lambda: jnp.sum(model.train_operator(q, x).solve(r) * w))

        out["solve"] = jax.value_and_grad(solve_loss, argnums=(0, 1))(p, rhs)
        out["posterior"] = under("posterior", lambda: model.posterior(p, x, y, x_star))
        out["cache"] = under("cache", lambda: model.posterior_from_cache(
            p, x, model.posterior_cache(p, x, y, key=key), x_star))
        return out

    jax.random.normal = draw
    try:
        res = _jit(everything)(params, rhs)
    finally:
        jax.random.normal = normal

    def grads(g):
        return np.array([float(jnp.sum(g.raw_lengthscale)), float(jnp.sum(g.raw_outputscale)), float(g.raw_noise)])

    out = {case: dict(loss=float(res[case][0]), grads=grads(res[case][1]))
           for case in ("pivoted", "nystrom", "auto", "cholesky")}
    (value, (g, rhs_grad)) = res["solve"]
    out["solve"] = dict(loss=float(value), grads=grads(g), rhs_grad=np.asarray(rhs_grad))
    for case in ("posterior", "cache"):
        out[case] = dict(mean=np.asarray(res[case][0]), var=np.asarray(res[case][1]))
    return out


def _jax_roots(n):
    """The JAX package's unsharded results of the roots' runs (the worker's
    ``_roots``) on the same data and draws, in one jitted function:
    posterior_distribution's mean, covariance, draws and log_prob and the
    gradient of sum(mean) + sum(covariance); the root, the inverse root and
    the Cholesky route's root with the gradient of |R^T w|^2; the root's
    draws; diagonalization; the blocked pivoted sweep on each system."""
    arrays = _serve_data(n)
    x, y, x_star, w, y_star, iv = (jnp.asarray(arrays[k]) for k in ("x", "y", "x_star", "w", "y_star", "iv"))
    w1 = w[..., :1]
    draws = {v.shape: v for k, v in arrays.items() if k.startswith("draw")}
    model = JaxGP(block_rows=32, materialize_threshold=None)
    per_system = (SERVE_B, 1, 1)
    params = model.init_params(D, dtype=jnp.float64)._replace(
        raw_lengthscale=jnp.full(per_system, PARAMS[0], jnp.float64),
        raw_outputscale=jnp.full(per_system, PARAMS[1], jnp.float64),
        raw_noise=jnp.asarray(PARAMS[2], jnp.float64))
    scalar = model.init_params(D, dtype=jnp.float64)._replace(
        **{name: jnp.asarray(v, jnp.float64) for name, v in zip(("raw_lengthscale", "raw_outputscale",
                                                                 "raw_noise"), PARAMS)})
    key = jax.random.PRNGKey(7)

    def everything(p, q):
        out = {}

        def dist(p):
            mvn = model.posterior_distribution(p, x, y, x_star, key=key)
            cov = mvn.covariance_matrix
            aux = (mvn.mean, cov, mvn.rsample(key, (SAMPLES,)), mvn.log_prob(y_star))
            return jnp.sum(mvn.mean) + jnp.sum(cov), aux

        out["distribution"] = _under({**SETTINGS, **ROOTS}, lambda: jax.value_and_grad(dist, has_aux=True)(p))
        for case, over, inverse in (("root", ROOTS, False), ("inv_root", ROOTS, True),
                                    ("chol_root", ROOTS_CHOLESKY, False)):
            def loss(p, inverse=inverse):
                K = model.train_operator(p, x)
                root = K.root_inv_decomposition(key=key) if inverse else K.root_decomposition(key=key)
                R = root.root.to_dense()
                proj = jnp.sum(R * w1, axis=-2)
                return jnp.sum(proj * proj), R

            out[case] = _under({**SETTINGS, **over}, lambda loss=loss: jax.value_and_grad(loss, has_aux=True)(p))
        K = model.train_operator(p, x)
        out["diagonalization"] = _under({**SETTINGS, **ROOTS}, lambda: K.diagonalization(key=key))
        out["samples"] = _under({**SETTINGS, **ROOTS}, lambda: K.zero_mean_mvn_samples(SAMPLES, key=key))
        out["symeig"] = _under({**SETTINGS, **ROOTS}, lambda: K.root_inv_decomposition(method="symeig").root.to_dense())
        out["initial"] = _under({**SETTINGS, **ROOTS},
                                lambda: K.root_inv_decomposition(initial_vectors=iv).root.to_dense())
        out["blocked"] = [jsolvers_blocked(model.covariance(q, x[b]), BLOCK_RANK, None, BLOCK_SIZE)
                          for b in range(SERVE_B)]
        return out

    res = _with_draws(draws, lambda: _jit(everything)(params, scalar))

    def grads(g):
        return np.array([float(jnp.sum(g.raw_lengthscale)), float(jnp.sum(g.raw_outputscale)), float(g.raw_noise)])

    (_, (mean, cov, samples, log_prob)), g = res["distribution"]
    out = {"distribution": dict(mean=np.asarray(mean), cov=np.asarray(cov), draws=np.asarray(samples),
                                log_prob=np.asarray(log_prob), grads=grads(g))}
    for case in ("root", "inv_root", "chol_root"):
        (_, R), g = res[case]
        R = np.asarray(R)
        out[case] = dict(gram=R @ np.swapaxes(R, -1, -2), grads=grads(g))
    evals, Q = res["diagonalization"]
    Q = np.asarray(Q.to_dense())
    out["diagonalization"] = dict(evals=np.asarray(evals),
                                  gram=(Q * np.asarray(evals)[..., None, :]) @ np.swapaxes(Q, -1, -2))
    out["samples"] = np.asarray(res["samples"])
    for case in ("symeig", "initial"):
        S = np.asarray(res[case])
        out[case] = dict(gram=S @ np.swapaxes(S, -1, -2))
    out["blocked"] = [np.asarray(L) for L in res["blocked"]]
    return out


def _under(case_settings, fn):
    ctxs = [getattr(jlo.settings, k)(v) for k, v in case_settings.items()]
    for c in ctxs:
        c.__enter__()
    try:
        return fn()
    finally:
        for c in reversed(ctxs):
            c.__exit__(None, None, None)


def _with_draws(draws, fn):
    """``fn()`` with ``jax.random.normal`` handing out ``draws`` by shape."""
    normal = jax.random.normal
    jax.random.normal = lambda key, shape=(), dtype=jnp.float64: jnp.asarray(draws[tuple(shape)], dtype)
    try:
        return fn()
    finally:
        jax.random.normal = normal


def _jax_ski(interp, n):
    """The JAX package's unsharded SKI model on the same data and draws, in
    one jitted function: neg_mll and its gradient under each SKI case, and
    the LOVE posterior; indexing the train operator (the worker's
    ``_ski_index``)."""
    arrays = _ski_data(n)
    draws = {v.shape: v for k, v in arrays.items() if k.startswith("draw")}
    x, y, x_star = (jnp.asarray(arrays[k]) for k in ("x", "y", "x_star"))
    model = jlo.models.SKIGPRegression(jlo.models.GridSpec(jnp.asarray(arrays["mins"]), jnp.asarray(arrays["maxs"]),
                                                           SKI_GRID), interp=interp)
    params = model.init_params(2, dtype=jnp.float64)
    key = jax.random.PRNGKey(1)

    idx = np.array(ski_index(n))

    def everything(p, x):
        K = model.train_operator(p, x)
        out = {"index": dict(rows=K[idx, :].to_dense(), block=K[2:20, 5:30].to_dense(), cols=K[:, idx].to_dense(),
                             entries=K[idx, idx[::-1]])}
        for case, over in SKI_CASES.items():
            over = {**SETTINGS, **over}
            if case == "posterior":
                out[case] = _under(over, lambda: model.posterior(p, x, y, x_star, key=key))
            else:
                # with x's gradient (through the interpolation weights)
                out[case] = jax.value_and_grad(lambda q, xx, o=over: _under(o, lambda: model.neg_mll(q, xx, y, key=key)),
                                               argnums=(0, 1) if case in SKI_X_GRAD else 0)(p, x)
        return out

    res = _with_draws(draws, lambda: _jit(everything)(params, x))
    out = {"index": {k: np.asarray(v) for k, v in res.pop("index").items()}}
    for case, (v, g) in res.items():
        if case != "posterior":
            g, x_grad = g if case in SKI_X_GRAD else (g, None)
            out[case] = dict(loss=float(v), grads=np.concatenate([np.ravel(np.asarray(leaf)) for leaf in g]))
            if x_grad is not None:
                out[case]["x_grad"] = np.asarray(x_grad)
    out["posterior"] = dict(mean=np.asarray(res["posterior"][0]), var=np.asarray(res["posterior"][1]))
    return out


def _jax_dkl(n):
    """The JAX package's unsharded DKL loss and gradients (each layer's
    weights, the biases, the GP head's) on the same data and probes."""
    arrays = _dkl_data(n)
    model = jlo.models.DeepKernelGPRegression(hidden=DKL_HIDDEN, materialize_threshold=None, block_rows=32)
    layers = len(DKL_HIDDEN)
    mlp = jlo.models.dkl.MLPParams(tuple(jnp.asarray(arrays[f"w{i}"]) for i in range(layers)),
                                   tuple(jnp.asarray(arrays[f"b{i}"]) for i in range(layers)))
    gp = model.gp.init_params(DKL_HIDDEN[-1], dtype=jnp.float64)._replace(
        **{name: jnp.asarray(v, jnp.float64) for name, v in zip(("raw_lengthscale", "raw_outputscale",
                                                                 "raw_noise"), PARAMS)})
    params = jlo.models.dkl.DKLParams(mlp, gp)
    x, y = jnp.asarray(arrays["x"]), jnp.asarray(arrays["y"])

    def loss(p):
        return _under(SETTINGS, lambda: model.neg_mll(p, x, y, key=jax.random.PRNGKey(7)))

    value, g = _with_draws({arrays["draw"].shape: arrays["draw"]}, lambda: _jit(jax.value_and_grad(loss))(params))
    return float(value), np.concatenate([np.ravel(np.asarray(leaf)) for leaf in (*g.mlp.weights, *g.mlp.biases,
                                                                                  *g.gp)])


def _jax_process() -> None:
    """A reference process's JAX: the test configuration's (the CPU, f64)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds spawned at once (each rank one process), the JAX
    references computed while they run, in REF_PROCESSES processes of their
    own; a rank that fails ends its world at once, and each world has its
    own timeout."""
    tmp = tmp_path_factory.mktemp("parallel")
    arrays = {}
    for n in SIZES:
        x, y, probes = _data(n)
        arrays.update({f"n{n}_x": x, f"n{n}_y": y, f"n{n}_probes": probes, f"n{n}_params": np.array(PARAMS)})
        arrays.update({f"s{n}_{k}": v for k, v in _serve_data(n).items()})
        arrays[f"s{n}_params"] = np.array(PARAMS)
        arrays.update({f"dkl{n}_{k}": v for k, v in _dkl_data(n).items()})
    for n in SKI_SIZES:
        arrays.update({f"ski{n}_{k}": v for k, v in _ski_data(n).items()})
    arrays.update({f"a{ALGEBRA_N}_{k}": v for k, v in _algebra_data(ALGEBRA_N).items()})
    np.savez(tmp / "arrays.npz", **arrays)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["OMP_NUM_THREADS"] = "1"
    procs, started = {}, time.perf_counter()
    for world, runs in _runs().items():
        out = tmp / f"world{world}"
        out.mkdir()
        spec = out / "spec.json"
        spec.write_text(json.dumps(dict(arrays=str(tmp / "arrays.npz"), runs=runs, scaling=world == 4)))
        port = _free_port()
        procs[world] = [
            subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(port), str(spec), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)
        ]
    # the JAX references, longest first, in processes of their own
    jobs = [((interp, n), _jax_ski, (interp, n)) for interp, n in
            sorted({(i, n) for cases in SKI_RUNS.values() for i, _, n in cases})]
    jobs.append((f"a{ALGEBRA_N}", _jax_algebra, (ALGEBRA_N,)))
    jobs += [(f"{key}{n}", fn, (n,)) for key, fn in (("s", _jax_serving), ("roots", _jax_roots), ("dkl", _jax_dkl))
             for n in SIZES]
    jobs += [(n, _jax_reference, (n,)) for n in SIZES]
    context = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(REF_PROCESSES, mp_context=context, initializer=_jax_process) as pool:
        futures = [(key, pool.submit(fn, *args)) for key, fn, args in jobs]
        refs = {key: future.result() for key, future in futures}
    results, failures = {}, []
    for world, ranks in procs.items():
        deadline = started + TIMEOUT_S
        while any(p.poll() is None for p in ranks):
            if time.perf_counter() > deadline or any(p.poll() not in (None, 0) for p in ranks):
                break
            time.sleep(0.05)
        for p in ranks:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in ranks]
        for r, (p, text) in enumerate(zip(ranks, outs)):
            if p.returncode != 0:
                failures.append(f"world {world} rank {r} exited {p.returncode}:\n{text[-3000:]}")
        if not failures:
            results[world] = [json.loads((tmp / f"world{world}" / f"rank{r}.json").read_text()) for r in range(world)]
    assert not failures, "\n".join(failures)
    return results, refs


def _cases(kind):
    for world, runs in _runs().items():
        for run in runs:
            if run.get("serve") or run.get("ski") or run.get("dkl") or run.get("algebra"):
                if run.get(kind):
                    yield pytest.param(world, run, id=run["name"])
                continue
            if kind == "f64" and run["dtype"] == "float64":
                yield pytest.param(world, run, id=run["name"])
            elif kind == "fused" and run["fused"]:
                yield pytest.param(world, run, id=run["name"])
            elif kind == "raises" and run.get("raises"):
                yield pytest.param(world, run, id=run["name"])


def _grad_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.linalg.norm(want), (got, want)


@pytest.mark.parametrize("world, run", list(_cases("f64")))
def test_sharded_loss_and_grads_match_jax(worlds, world, run):
    """Every rank's loss (the whole batch's mean, the same on all ranks) and
    gradient against the JAX package's unsharded ones, and its CG iteration
    count against the unsharded run's."""
    results, refs = worlds
    want_loss, want_grads, _ = refs[int(run["case"][1:])]
    ranks = [r[run["name"]] for r in results[world]]
    for out in ranks:
        np.testing.assert_allclose(out["loss"], want_loss, rtol=LOSS_RTOL)
        _grad_close(out["grads"], want_grads, GRAD_RTOL)
        np.testing.assert_allclose(out["ref_loss"], want_loss, rtol=LOSS_RTOL)
        assert out["iters"] == out["ref_iters"] and len(out["iters"]) == 1
    assert len({out["loss"] for out in ranks}) == 1
    assert len({tuple(out["grads"]) for out in ranks}) == 1


@pytest.mark.parametrize("world, run", list(_cases("f64")))
def test_sharded_train_step_moves_as_adam(worlds, world, run):
    """One sharded_train_step: the loss it returns is the sharded loss, its
    gradients (shares summed over data, once) the JAX gradient, and the
    parameters move as Adam's first step on that gradient moves them."""
    results, refs = worlds
    _, want_grads, _ = refs[int(run["case"][1:])]
    moved = np.array(PARAMS) - LR * want_grads / (np.abs(want_grads) + ADAM_EPS)
    for r in results[world]:
        out = r[run["name"]]
        assert out["step_loss"] == out["loss"]
        _grad_close(out["step_grads"], want_grads, GRAD_RTOL)
        np.testing.assert_allclose(out["step_params"], moved, rtol=0, atol=LR * GRAD_RTOL)


@pytest.mark.parametrize("world, run", list(_cases("f64")))
def test_collectives_follow_the_design(worlds, world, run):
    """The collectives the layout implies, counted by name: one "any" a
    stopping test (the 20 tridiagonal iterations take none, and CG at its
    cap stops without one), one gathered
    vector a CG iteration plus x's once where rows are sharded, none on a
    one-rank axis; the backward gathers once and reduces the operator's
    gradient shares once."""
    results, _ = worlds
    data, model, probe = run["layout"]
    for r in results[world]:
        out = r[run["name"]]
        iters = out["iters"][0]
        counts, back = out["counts"], out["backward_counts"]
        assert counts.get("any", 0) == iters - 20 + (iters < SETTINGS["max_cg_iterations"])
        assert counts.get("all_gather", 0) == (iters + 1 if model > 1 else 0)
        assert back.get("all_gather", 0) == (1 if model > 1 else 0)
        # backward: the operator's shares over model and probe, then the
        # worker's sum over data
        assert back.get("all_reduce", 0) == (model > 1 or bool(probe)) + (data > 1)
    for rank, r in enumerate(results[world]):
        place = Mesh({"data": data, "model": model, **({"probe": probe} if probe else {})}, rank, torch.device("cpu"))
        assert r[run["name"]]["rows"] == split_sizes(int(run["case"][1:]), model)[place.index("model")]


@pytest.mark.parametrize("world, run", list(_cases("fused")))
def test_fused_route_matches_unsharded(worlds, world, run):
    """float32 on the fused route (the kernels' plain versions here): the
    row-sharded operator takes K1 only, forward and backward, a mesh with
    model = 1 K3 only; loss and gradient as the unsharded port's."""
    results, _ = worlds
    model = run["layout"][1]
    for r in results[world]:
        out = r[run["name"]]
        assert set(out["routes"]) == {"K1" if model > 1 else "K3"}
        assert set(out["backward_routes"]) == {"K1" if model > 1 else "K3"}
        assert out["routes"].count(out["routes"][0]) == out["iters"][0]
        np.testing.assert_allclose(out["loss"], out["ref_loss"], rtol=FUSED_RTOL)
        _grad_close(out["grads"], out["ref_grads"], FUSED_RTOL)
        assert out["iters"] == out["ref_iters"]


@pytest.mark.parametrize("world, run", list(_cases("raises")))
def test_what_the_row_sharded_operator_does_not_cover_raises(worlds, world, run):
    """What a model-sharded mesh once refused now runs on it: on (1, 2),
    (2, 2) and (1, 2, 2) nothing of ROADMAP.md queue 1 raises any more
    (indexing, cat_rows, a sum with another operator, add_low_rank, mul, a
    batch expansion, sqrt_inv_matmul and CIQ's draws, beside
    posterior_distribution, the forward root and the blocked pivoted sweep
    of earlier slices); the values are held against the JAX package by the
    algebra tests."""
    results, _ = worlds
    for r in results[world]:
        raised = r[run["name"]]["raised"]
        assert set(raised) == {"posterior_distribution", "forward root", "blocked pivoted sweep", "indexing",
                               "cat_rows", "sum", "add_low_rank", "mul", "batch expansion", "sqrt_inv_matmul",
                               "CIQ draws"}
        assert all(v == "nothing" for v in raised.values()), raised


def _serve_cases(row_sharded=False):
    for world, runs in _runs().items():
        for run in runs:
            if run.get("serve") and (run["layout"][1] > 1 or not row_sharded):
                for case in SERVE:
                    yield pytest.param(world, run, case, id=f"{run['name']}-{case}")


def _place(run, rank):
    data, model, probe = run["layout"]
    mesh = Mesh({"data": data, "model": model, **({"probe": probe} if probe else {})}, rank, torch.device("cpu"))
    n = int(run["case"][1:])
    batch = torch.tensor_split(torch.arange(SERVE_B), data)[mesh.index("data")]
    rows = torch.tensor_split(torch.arange(n), model)[mesh.index("model")]
    return mesh, batch.numpy(), rows.numpy()


@pytest.mark.parametrize("world, run, case", list(_serve_cases()))
def test_sharded_serving_matches_jax(worlds, world, run, case):
    """On each mesh (the data-only one too), on the same data and draws as
    the JAX package's unsharded functions: neg_mll and its gradient under the
    pivoted (rank 5), Nystrom (rank 8) and auto preconditioners and on the
    Cholesky route; solve, with its gradients in the parameters and (the
    rank's rows) in the rhs; the posterior, and its gradient against the
    unsharded port's; the LOVE cache's predictions (a root is defined only
    up to rotation).  Every rank's outputs are its
    batch's, the same on every model rank."""
    results, refs = worlds
    want = refs[run["case"]][case]
    for rank, r in enumerate(results[world]):
        got = r[run["name"]][case]
        _, batch, rows = _place(run, rank)
        if "loss" in want:
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
            _grad_close(got["grads"], want["grads"], GRAD_RTOL)
        if "rhs_grad" in want:
            np.testing.assert_allclose(got["rhs_grad"], want["rhs_grad"][batch][:, rows], rtol=0,
                                       atol=GRAD_RTOL * np.abs(want["rhs_grad"]).max())
        for key in ("mean", "var"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key][batch], rtol=0,
                                           atol=SERVE_RTOL * np.abs(want[key]).max())
        if case == "posterior":
            # the gradient of sum(mean + var): the solve's shares and the
            # cross-covariance's summed over the model group, the data
            # ranks' over data, against the unsharded port's
            _grad_close(got["grads"], got["ref_grads"], GRAD_RTOL)


@pytest.mark.parametrize("world, run, case", list(_serve_cases(row_sharded=True)))
def test_sharded_serving_collectives_follow_the_design(worlds, world, run, case):
    """The collectives by name each case implies, from the forward's counts:
    one gathered vector a CG iteration and a Lanczos step (x's once), one
    Woodbury sum a preconditioner application, two row sums a CG iteration,
    one "any" a stopping test, the pivoted factor's argmax and owner's row
    a step, one sum of the posterior's or a query's shares; every gathered
    block is the rank's rows of one block of vectors (the Cholesky route
    gathers its own n x n rows once)."""
    results, _ = worlds
    data, model, probe = run["layout"]
    n = int(run["case"][1:])
    for rank, r in enumerate(results[world]):
        got = r[run["name"]][case]
        counts, its, gathered = got["counts"], got["iters"], got["gathered"]
        _, _, rows = _place(run, rank)
        want = {}
        pivoted = case != "cholesky" and SERVE[case].get("preconditioner_mode", "pivoted") == "pivoted"
        if pivoted:
            want.update(argmax=5, owner_row=4)
        if case == "cholesky":
            assert its == []
            want.update(all_reduce=1 + (data > 1), all_gather=3)
            widths = [D, n, 1]
        elif case in ("pivoted", "nystrom", "auto"):
            (it,) = its
            tests = it - 20 + (it < SETTINGS["max_cg_iterations"])
            want.update(all_gather=it + 1, woodbury=it + 2, woodbury_cap=1, nan_check=1, any=tests,
                        all_reduce=2 * it + 6 + (data > 1) + (probe is not None) * (2 + tests))
            widths = [D] + [PROBES // (probe or 1) + 1] * it
        else:
            it = its[0]
            tests = it + 1 - (it == SERVE[case]["max_cg_iterations"])
            want.update(all_gather=it + 1, woodbury=it + 1, woodbury_cap=1, nan_check=1, any=tests,
                        all_reduce=2 * it + 4)
            width = {"solve": 3, "posterior": 1 + SERVE_M, "cache": 1}[case]
            widths = [D] + [width] * it
            if case == "posterior":
                want["posterior"] = 1
            if case == "cache":
                k = min(n, 100)
                want.update(all_gather=it + 1 + k, lanczos=4 * k + 1)
                widths += [1] * k
                assert got["query_counts"] == {"posterior_from_cache": 1}
                assert got["root_rows"] == len(rows)
        assert counts == want, (counts, want)
        assert gathered == [[len(rows), w] for w in widths]


def test_top_takes_the_whole_arrays_stable_order(worlds):
    """_comm.top over a model group of 4 whose ranks hold 3, 3, 3 and 2 of 11
    entries, k = 10: the first ten of a stable descending sort of the whole
    array (ties to the lowest index, a buried -inf entry before every rank's
    padding), on every rank, with the extra (each rank's row count) summed."""
    whole = torch.tensor([1.0, 3.0, 3.0, -torch.inf, 2.0, 3.0, 0.5, 2.0, -torch.inf, 3.0, 2.0])
    order = torch.sort(whole, descending=True, stable=True)
    for r in worlds[0][4]:
        assert r["top"]["index"] == order.indices[:10].tolist() == [1, 2, 5, 9, 4, 7, 10, 0, 6, 3]
        assert r["top"]["value"] == order.values[:10].tolist()
        assert r["top"]["total"] == [11.0]


def test_scaling_report_on_meshes_of_two_and_four_ranks(worlds):
    """scaling_report([2, 4], model_axis=2) in the world of 4: the ranks of
    the 2-rank mesh measure it and the 4-rank one, the two idle ranks only
    the latter; each entry has its mesh, solves/s and the efficiency against
    the first."""
    results, _ = worlds
    for rank, r in enumerate(results[4]):
        report = r["scaling"]
        assert set(report) == ({"2", "4"} if rank < 2 else {"4"})
        assert report["4"]["mesh"] == {"data": 2, "model": 2}
        assert all(np.isfinite(e["solves_per_s"]) and e["solves_per_s"] > 0 for e in report.values())
        if rank < 2:
            assert report["2"]["mesh"] == {"data": 1, "model": 2} and report["2"]["efficiency"] == 1.0


# ---------------------------------------------------------------------------
# x's gradient, DKL and SKI on the model axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world, run", list(_cases("f64")))
def test_x_gradient_through_the_row_sharded_operator_matches_jax(worlds, world, run):
    """An exact GP with a trainable x: each rank's gradient in its own rows
    (its own rows' share, never summed over the model group, plus its rows
    of the gathered x's summed gradient) against the JAX package's gradient
    in x, and the hyperparameters' gradients unchanged by it.  Where the
    rows are sharded, the backward makes one sum of the replicated
    gradients over the model (and probe) group and, with a probe axis, one
    of the own rows' over the probe group."""
    results, refs = worlds
    n = int(run["case"][1:])
    _, want_grads, want_x = refs[n]
    data, model, probe = run["layout"]
    for rank, r in enumerate(results[world]):
        out = r[run["name"]]
        place = Mesh({"data": data, "model": model, **({"probe": probe} if probe else {})}, rank, torch.device("cpu"))
        batch = torch.tensor_split(torch.arange(B), data)[place.index("data")].numpy()
        rows = torch.tensor_split(torch.arange(n), model)[place.index("model")].numpy()
        np.testing.assert_allclose(out["x_grad"], want_x[batch][:, rows], rtol=0,
                                   atol=GRAD_RTOL * np.abs(want_x).max())
        assert np.abs(out["x_grad"]).max() > 0.0
        # the worker's shares are summed over data by the test's own sum
        if data == 1:
            _grad_close(out["x_grads"], want_grads, GRAD_RTOL)
        back = out["x_backward_counts"]
        assert back.get("all_reduce", 0) == (model > 1 or bool(probe)) + (model > 1 and bool(probe))


@pytest.mark.parametrize("world, run", list(_cases("dkl")))
def test_sharded_dkl_matches_jax(worlds, world, run):
    """DKL on the rank's block (d_in 3, hidden (8, 2), B = 2, float64): the
    loss, the same on every rank, and every gradient (each MLP layer's
    weights and biases and the GP head's) after sharded_train_step's one
    sum over the mesh against the JAX package's unsharded ones; a gradient
    counted twice (the GP head's summed again over model, or an MLP share
    missed) moves them by O(1)."""
    results, refs = worlds
    want_loss, want_grads = refs[run["case"]]
    ranks = [r[run["name"]] for r in results[world]]
    for out in ranks:
        np.testing.assert_allclose(out["loss"], want_loss, rtol=LOSS_RTOL)
        _grad_close(out["step_grads"], want_grads, GRAD_RTOL)
        first = slice(0, DKL_D * DKL_HIDDEN[0])
        _grad_close(out["step_grads"][first], want_grads[first], GRAD_RTOL)
        _grad_close(out["ref_grads"], want_grads, GRAD_RTOL)
    assert len({out["loss"] for out in ranks}) == 1
    assert len({tuple(out["step_grads"]) for out in ranks}) == 1


@pytest.mark.parametrize("world, run", list(_cases("dkl")))
def test_sharded_dkl_train_step_moves_as_adam(worlds, world, run):
    """Two sharded_train_step steps with Adam move every parameter (the
    MLP's and the GP head's) as two Adam steps on the unsharded port on the
    whole data; the backward gathers the features once and sums the
    replicated gradients once."""
    results, _ = worlds
    data, model, probe = run["layout"]
    for r in results[world]:
        out = r[run["name"]]
        np.testing.assert_allclose(out["step_params"], out["ref_params"], rtol=0, atol=2 * LR * GRAD_RTOL)
        assert out["counts"]["all_gather"] == out["iters"][0] + 1
        assert out["backward_counts"].get("all_gather", 0) == 1
        assert out["backward_counts"].get("all_reduce", 0) == 1 + bool(probe)


def _ski_runs(cases=tuple(SKI_CASES)):
    for world, runs in _runs().items():
        for run in runs:
            if run.get("ski"):
                for case in cases:
                    yield pytest.param(world, run, case, id=f"{run['name']}-{case}")


@pytest.mark.parametrize("world, run, case", list(_ski_runs()))
def test_sharded_ski_matches_jax(worlds, world, run, case):
    """Row-sharded SKI (linear on model 2 and 4, cubic on model 4, n = 512
    and the uneven 513) against the JAX package's unsharded SKIGPRegression
    on the same data and draws: neg_mll and its gradient with no
    preconditioner (TestShardedSKI's settings), pivoted (rank 5), Nystrom
    (rank 8) and on the Cholesky route; the LOVE posterior's mean and
    variance.  The same on every rank."""
    results, refs = worlds
    want = refs[(run["interp"], int(run["case"][3:]))][case]
    ranks = [r[run["name"]][case] for r in results[world]]
    for got in ranks:
        if case == "posterior":
            for key in ("mean", "var"):
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=SERVE_RTOL * np.abs(want[key]).max())
        else:
            loss_rtol, grad_rtol = SKI_RTOL.get(case, (LOSS_RTOL, GRAD_RTOL))
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
            _grad_close(got["grads"], want["grads"], grad_rtol)
    key = "mean" if case == "posterior" else "loss"
    assert len({str(got[key]) for got in ranks}) == 1


@pytest.mark.parametrize("world, run", list(_cases("ski")))
def test_sharded_ski_indexing_matches_unsharded(worlds, world, run):
    """Indexing the row-sharded SKI operator (InterpolatedRows: linear on
    model 2 and 4, cubic on 4) beside the unsharded port's operator on the
    whole data set (which tests/test_torch_ski.py holds against the JAX
    package): a row selection and a rectangular block, the same on every
    rank, each rank's rows of a column selection, and pointwise entries,
    within ALGEBRA_RTOL of the largest entry; one collective each (the
    rows' and columns' stencils from their owners, "index")."""
    results, _ = worlds
    n = int(run["case"][3:])
    for rank, r in enumerate(results[world]):
        got = r[run["name"]]["index"]
        assert max(got["errs"].values()) <= ALGEBRA_RTOL, got["errs"]
        assert got["counts"] == {"index": 4}, got["counts"]
        assert got["shapes"] == dict(rows=[5, n], block=[18, 25], cols=[split_sizes(n, run["layout"][1])[rank], 5],
                                     entries=[5])


@pytest.mark.parametrize("world, run", list(_cases("ski")))
def test_sharded_ski_indexing_matches_jax(worlds, world, run):
    """Indexing the row-sharded SKI operator against the JAX package's
    unsharded SKI train operator on the same data: the row selection, the
    rectangular block and the entries the same on every rank, each rank's
    rows of the column selection, within ALGEBRA_RTOL of the largest
    entry."""
    results, refs = worlds
    n = int(run["case"][3:])
    want = refs[(run["interp"], n)]["index"]
    for rank, r in enumerate(results[world]):
        got = r[run["name"]]["index"]["values"]
        rows = slice(None)
        for key, ref in want.items():
            if key == "cols":
                sizes = split_sizes(n, run["layout"][1])
                rows = slice(sum(sizes[:rank]), sum(sizes[: rank + 1]))
            _held(got[key], ref[rows] if key == "cols" else ref, ALGEBRA_RTOL)


@pytest.mark.parametrize("world, run", list(_cases("ski")))
def test_sharded_ski_neg_mll_is_the_whole_data_set_loss(worlds, world, run):
    """Given shard_gp_batch's rows of one data set, each rank's neg_mll is
    the whole data set's (the JAX package's unsharded loss), not the loss of
    its own rows alone: its operator is n x n, its rows |R| < n."""
    results, refs = worlds
    n = int(run["case"][3:])
    want = refs[(run["interp"], n)]["nystrom"]["loss"]
    for rank, r in enumerate(results[world]):
        out = r[run["name"]]
        assert out["rows"] == split_sizes(n, run["layout"][1])[rank] < n
        np.testing.assert_allclose(out["nystrom"]["loss"], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("world, run, case", list(_ski_runs()))
def test_sharded_ski_collectives_follow_the_design(worlds, world, run, case):
    """The collectives by name: one interpolation sum ("interp", W_R^T v over
    the model group) a mat-vec (each CG iteration and Lanczos step) and one
    in the backward, no gathered (n, t) vector anywhere (the Cholesky route
    gathers the stencils and its own n x n rows once); the pivoted factor's
    argmax a step and its owner's rows (the pivot's row of L and its
    stencil), the Nystrom landmarks' stencils once."""
    results, _ = worlds
    for r in results[world]:
        got = r[run["name"]][case]
        counts, its = got["counts"], got["iters"]
        if case == "cholesky":
            assert its == [] and "interp" not in counts
            rows, k = r[run["name"]]["rows"], SKI_STENCIL[run["interp"]]
            assert got["gathered"] == [[rows, k], [rows, k], [rows, int(run["case"][3:])], [rows, 1]]
            continue
        assert got["gathered"] == []
        (it,) = its if case != "posterior" else its[:1]
        if case == "posterior":
            k = min(int(run["case"][3:]), 100)
            assert counts["interp"] == it + k and counts["posterior"] == 1
        else:
            assert counts["interp"] == it
            assert got["backward_counts"]["interp"] == 1
        if case == "pivoted":
            assert counts["argmax"] == 5 and counts["owner_row"] == 4 + 5
        if case == "nystrom":
            assert counts["landmarks"] == 1
        if case == "blocked":
            # a pool choice and a fetch of its stencils and rows of L a sweep
            assert counts["pool"] >= 3 and counts["top"] in (counts["pool"], counts["pool"] + 1)



# ---------------------------------------------------------------------------
# The roots, posterior_distribution and the blocked sweep on the model axis
# ---------------------------------------------------------------------------

ROOT_CASES = ("distribution", "root", "inv_root", "chol_root", "symeig", "initial", "diagonalization", "samples",
              "blocked")


def _root_runs(cases=ROOT_CASES):
    for world, runs in _runs().items():
        for run in runs:
            if run.get("roots"):
                for case in cases:
                    yield pytest.param(world, run, case, id=f"{run['name']}-{case}")


def _whole(run, ranks, get):
    """{data index: the model group's rows of ``get(rank's roots)`` joined
    in row order (rows on dim -2)}, from the ranks of probe index 0."""
    joined = {}
    for rank, r in enumerate(ranks):
        mesh, batch, _ = _place(run, rank)
        if mesh.size("probe") > 1 and mesh.index("probe") > 0:
            continue
        joined.setdefault(int(batch[0]), []).append((mesh.index("model"), np.asarray(get(r[run["name"]]["roots"]))))
    return {b: np.concatenate([a for _, a in sorted(parts, key=lambda p: p[0])], axis=-2)
            for b, parts in joined.items()}


@pytest.mark.parametrize("world, run, case", list(_root_runs()))
def test_sharded_roots_match_jax(worlds, world, run, case):
    """On (1, 2), (2, 2) and (1, 2, 2) at n = 32 and 33, against the JAX
    package's unsharded functions on the same data and draws (ROOTS'
    settings: CG and n Lanczos steps on the training set, the m x m
    covariance on the Cholesky route):
    posterior_distribution's mean, covariance, two draws under one
    generator and log_prob, the same on every model rank, and the gradient
    of sum(mean) + sum(covariance) (through the inverse root's); the
    forward root's, the inverse root's and the Cholesky route's R R^T from
    the ranks' rows, with the gradient of |R^T w|^2, and the inverse
    root's by symeig and from two given start vectors (the better by the
    residual test, its sums over the rows); diagonalization's
    eigenvalues and Q diag(evals) Q^T; the root's draws (the ranks' rows of
    the unsharded draws); the blocked pivoted sweep (rank 24, block 8) on
    each data rank's first system: the unsharded port's pivots exactly,
    which the JAX factor confirms (its rows at them are lower triangular),
    and the factor's rows.  SERVE_RTOL of the largest entry, GRAD_RTOL of
    the gradient's norm."""
    results, refs = worlds
    want = refs[f"roots{run['case'][1:]}"]
    ranks = results[world]

    def close(got, ref):
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=SERVE_RTOL * np.abs(ref).max())

    if case == "distribution":
        for rank, r in enumerate(ranks):
            got, (_, batch, _) = r[run["name"]]["roots"][case], _place(run, rank)
            ref = want[case]
            for key in ("mean", "cov", "log_prob"):
                close(got[key], ref[key][batch])
            close(got["draws"], ref["draws"][:, batch])
            _grad_close(got["grads"], ref["grads"], GRAD_RTOL)
    elif case in ("root", "inv_root", "chol_root", "symeig", "initial", "diagonalization"):
        source = "root" if case == "diagonalization" else case
        if case == "diagonalization":
            def get(roots):
                q = np.asarray(roots["root"]["Q"])
                return q * np.asarray(roots["root"]["evals"])[..., None, :]

            grams = {b: a for b, a in _whole(run, ranks, get).items()}
            qs = _whole(run, ranks, lambda roots: roots["root"]["Q"])
            grams = {b: grams[b] @ np.swapaxes(qs[b], -1, -2) for b in grams}
            for rank, r in enumerate(ranks):
                _, batch, _ = _place(run, rank)
                close(r[run["name"]]["roots"]["root"]["evals"], want[case]["evals"][batch])
        elif case in ("symeig", "initial"):
            roots = _whole(run, ranks, lambda roots: roots["inv_root"][case])
            grams = {b: R @ np.swapaxes(R, -1, -2) for b, R in roots.items()}
        else:
            roots = _whole(run, ranks, lambda roots: roots[source]["R"])
            grams = {b: R @ np.swapaxes(R, -1, -2) for b, R in roots.items()}
            for r in ranks:
                _grad_close(r[run["name"]]["roots"][case]["grads"], want[case]["grads"], GRAD_RTOL)
        for b, gram in grams.items():
            _, batch, _ = _place(run, next(i for i in range(len(ranks)) if _place(run, i)[1][0] == b))
            close(gram, want[case]["gram"][batch])
    elif case == "samples":
        samples = _whole(run, ranks, lambda roots: np.swapaxes(np.asarray(roots["root"]["samples"]), -1, -2))
        for b, got in samples.items():
            _, batch, _ = _place(run, next(i for i in range(len(ranks)) if _place(run, i)[1][0] == b))
            close(np.swapaxes(got, -1, -2), want[case][:, batch])
    else:
        factors = _whole(run, ranks, lambda roots: roots["blocked"]["L"])
        for r in ranks:
            got = r[run["name"]]["roots"]["blocked"]
            ref = want["blocked"][got["system"]]
            assert got["pivots"] == got["ref_pivots"] and len(got["pivots"]) == ref.shape[-1]
            at = ref[got["pivots"]]
            assert np.abs(np.triu(at, 1)).max() <= 1e-12 * np.abs(ref).max() < np.abs(np.diag(at)).min()
            close(factors[got["system"]], ref)


@pytest.mark.parametrize("world, run", [p.values[:2] for p in _root_runs(("distribution",))])
def test_sharded_roots_collectives_follow_the_design(worlds, world, run):
    """posterior_distribution makes the LOVE cache's collectives and one
    (m, 1 + k) all-reduce of the mean and the downdate root; its
    covariance, draws and log_prob on the replicated m x m make none, and
    its backward one row sum of the inverse root's S^T S; the roots'
    backward one gathered block of vectors (the Lanczos roots) and one sum
    of the gradient shares, the Cholesky route's a gathered cotangent of
    its factor; the blocked sweep one choice of its pool (``top``) and one
    fetch of the pool's rows of L ("pool") a sweep, and one last choice that
    ends it."""
    results, _ = worlds
    for r in results[world]:
        roots = r[run["name"]]["roots"]
        dist = roots["distribution"]
        cache = r[run["name"]]["cache"]["counts"]  # the LOVE cache's, the same route
        assert dist["counts"] == {**cache, "posterior_distribution": 1}, (dist["counts"], cache)
        assert dist["used"] == {}
        assert dist["backward"]["root_grad"] == 1
        # x once, then one column a CG iteration and a Lanczos step
        assert [w for _, w in dist["gathered"]] == [D] + [1] * (len(dist["gathered"]) - 1)
        for case in ("root", "inv_root"):
            assert roots[case]["backward"] == {"all_gather": 1, "all_reduce": 1,
                                               **({"root_grad": 1} if case == "inv_root" else {})}
        assert roots["chol_root"]["counts"] == {"all_gather": 1}
        assert roots["chol_root"]["backward"] == {"all_gather": 1, "sum_grads": 1}
        blocked = roots["blocked"]["counts"]
        assert set(blocked) == {"top", "pool"} and blocked["top"] == blocked["pool"] + 1 >= 4


@pytest.mark.parametrize("world, run, case", list(_ski_runs(SKI_X_GRAD)))
def test_sharded_ski_x_gradient_matches_jax(worlds, world, run, case):
    """SKI with x requiring a gradient (linear on model 2 and 4, cubic on 4;
    Nystrom and the Cholesky route): each rank's gradient in its own rows,
    through the interpolation weights, against the JAX package's gradient
    in x, whose weights' share comes from a second sum of W_R^T left over
    the model group ("interp_left"), on the iterative route."""
    results, refs = worlds
    n = int(run["case"][3:])
    want = refs[(run["interp"], n)][case]["x_grad"]
    for rank, r in enumerate(results[world]):
        got = r[run["name"]][case]
        rows = torch.tensor_split(torch.arange(n), run["layout"][1])[rank].numpy()
        np.testing.assert_allclose(got["x_grad"], want[rows], rtol=0, atol=GRAD_RTOL * np.abs(want).max())
        if case != "cholesky":
            assert got["backward_counts"]["interp_left"] == 1


# ---------------------------------------------------------------------------
# Indexing, the algebra and CIQ on the model axis
# ---------------------------------------------------------------------------


def _algebra_runs(cases, kinds=("full", "index")):
    for world, runs in _runs().items():
        for run in runs:
            if run.get("algebra") in kinds:
                for case in cases:
                    yield pytest.param(world, run, case, id=f"{run['name']}-{case}")


def _rows_of(run, rank, sizes=None):
    """The rank's rows of a whole array (of ``sizes``, default the split of n)."""
    _, model, _ = run["layout"]
    sizes = split_sizes(ALGEBRA_N, model) if sizes is None else sizes
    start = sum(sizes[:rank])
    return slice(start, start + sizes[rank])


def _held(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("world, run, case", list(_algebra_runs(INDEX_CASES)))
def test_sharded_indexing_matches_jax(worlds, world, run, case):
    """Indexing the row-sharded train operator (n = 33, B = 2) on (1, 2) and
    on (1, 4), against the JAX package's unsharded indexing on the same
    data: a row selection K[..., idx, :] (idx spanning every rank), square
    and rectangular slices (the same on every rank), a column selection and
    a column slice (each rank's rows), a batch element (still row-sharded)
    and pointwise entries (with and without a batch index); each block's
    values and its product with a vector of its columns, within
    ALGEBRA_RTOL of the largest entry.  The square block stays a symmetric
    kernel operator with D's slice; no product of an indexed block makes a
    collective."""
    results, refs = worlds
    want = refs[f"a{ALGEBRA_N}"][case]
    for rank, r in enumerate(results[world]):
        got = r[run["name"]][case]
        rows = _rows_of(run, rank) if case in ("cols", "colslice") else slice(None)
        for key, ref in want.items():
            _held(got[key], ref[..., rows, :] if key in ("dense", "mv") and case != "batch" else ref, ALGEBRA_RTOL)
        assert got["counts"] == ({"all_gather": 1} if case == "batch" else {}), got["counts"]
        if case == "square":
            assert got["type"] == "AddedDiagLinearOperator" and got["symmetric"]
        if case == "batch":
            assert got["type"] == "RowShardedLinearOperator"


# the collectives of one product of each algebra result (K's own gathers
# its vector once)
ALGEBRA_PRODUCT_COUNTS = {
    "low_rank": {"all_gather": 1, "low_rank": 1}, "root_low_rank": {"low_rank": 1},
    "sum_op": {"all_gather": 2}, "sum_dense": {"all_gather": 2}, "sum_scalar": {"all_gather": 1},
    "mul": {"low_rank": 1}, "scaled": {"all_gather": 2}, "expand": {"all_gather": 1},
    "cat": {"all_gather": 1, "cat_rows": 1}, "cat_root": {"low_rank": 1},
}


@pytest.mark.parametrize("world, run, case", list(_algebra_runs(ALGEBRA_CASES, ("full",))))
def test_sharded_algebra_matches_jax(worlds, world, run, case):
    """The algebra on the row-sharded train operator (n = 33, B = 2, (1, 2)),
    against the JAX package's unsharded operator on the same data:
    add_low_rank (a lazy sum; with a carried root, the root's rows [R_R |
    V_R]), sums with another row-sharded operator, a dense tensor's rows
    and a scalar, mul of two roots, a constant multiple, a batch expansion
    and cat_rows (without and with a carried root: the last rank owns the
    3 new rows).  The whole values and each rank's rows of a product within
    ALGEBRA_RTOL of the largest entry; the solves' rows likewise, the
    gradient of sum(w * solve) within ALGEBRA_GRAD_RTOL of its norm, and the
    solved results' last batch element; one product's collectives by
    name.  The sum with another operator keeps D outside and is
    preconditioned (its Woodbury sums), as the unsharded sum is, and its
    solve takes the unsharded port's CG iterations (its Nystrom and blocked
    pivoted factors are the rows of the unsharded ones); add_low_rank and
    cat_rows, unpreconditioned unsharded, are so here, within one
    iteration of it."""
    results, refs = worlds
    want = refs[f"a{ALGEBRA_N}"][case]
    for rank, r in enumerate(results[world]):
        got = r[run["name"]][case]
        sizes = got.get("sizes") or (
            (*split_sizes(ALGEBRA_N, 2)[:-1], split_sizes(ALGEBRA_N, 2)[-1] + ALGEBRA_M) if case.startswith("cat")
            else None)
        rows = _rows_of(run, rank, sizes)
        _held(got["dense"], want["dense"], ALGEBRA_RTOL)
        if case == "sum_dense":  # the same sum with the whole dense operator
            _held(got["whole"], want["dense"], ALGEBRA_RTOL)
        _held(got["mv"], want["mv"][..., rows, :], ALGEBRA_RTOL)
        if "sol" in want:
            _held(got["sol"], want["sol"][..., rows, :], ALGEBRA_RTOL)
            _grad_close(got["grads"], want["grads"], ALGEBRA_GRAD_RTOL)
            # a batch element of the result, still row-sharded
            _held(got["batch_dense"], want["dense"][-1], ALGEBRA_RTOL)
            # the forward CG as the unsharded port runs it: preconditioned
            # where the unsharded sum keeps D outside, the same count; else
            # within one (unpreconditioned CG at 1e-11 on n = 33 stops at
            # its rounding floor, where the summation order moves the count)
            fwd, ref_fwd = got["sol_iters"][0], got["ref_iters"][0]
            assert len(got["sol_iters"]) == 2 and (fwd == ref_fwd if case == "sum_op" else abs(fwd - ref_fwd) <= 1), (
                got["sol_iters"], got["ref_iters"])
            assert ("woodbury" in got["solve_counts"]) == (case == "sum_op"), got["solve_counts"]
        if case == "sum_op":  # its Nystrom and blocked pivoted factors' rows
            assert max(got["factors"].values()) <= ALGEBRA_RTOL, got["factors"]
        assert got["type"] == "RowShardedLinearOperator"
        assert got["counts"] == ALGEBRA_PRODUCT_COUNTS[case], got["counts"]


@pytest.mark.parametrize("world, run, case", list(_algebra_runs(("ciq_precond", "ciq_plain", "ciq_samples"),
                                                                  ("full",))))
def test_sharded_ciq_matches_jax(worlds, world, run, case):
    """sqrt_inv_matmul on the row-sharded train operator (test_torch_ciq.py's
    settings, with the "auto" preconditioner and without) and CIQ's draws,
    against the JAX package's on the same data and draws: each rank's rows
    of the result and of the rhs's gradient, and the parameters' gradient of
    sum(V_0 * out) (of the draws' sum of squares), within CIQ_RTOL; MINRES's iterations those of the
    unsharded port.  The range estimate's Lanczos and every MINRES sum
    their inner products over the model group: two sums a MINRES step and
    two at its start."""
    results, refs = worlds
    want = refs[f"a{ALGEBRA_N}"][case]
    for rank, r in enumerate(results[world]):
        got = r[run["name"]][case]
        rows = _rows_of(run, rank)
        if case == "ciq_samples":
            _held(got["samples"], want["samples"][..., rows], CIQ_RTOL)
            _grad_close(got["grads"], want["grads"], CIQ_RTOL)
            continue
        _held(got["out"], want["out"][..., rows, :], CIQ_RTOL)
        _held(got["z_grad"], want["z_grad"][..., rows, :], CIQ_RTOL)
        _grad_close(got["grads"], want["grads"], CIQ_RTOL)
        assert got["minres"] == got["ref_minres"] and len(got["minres"]) == (4 if case == "ciq_precond" else 2)
        forward, backward = got["minres"][: len(got["minres"]) // 2], got["minres"][len(got["minres"]) // 2:]
        assert got["counts"]["minres"] == sum(2 + 2 * k for k in forward)
        assert got["backward"]["minres"] == sum(2 + 2 * k for k in backward)


@pytest.mark.parametrize("world, run", [p.values[:2] for p in _algebra_runs(("precond_op",), ("full",))])
def test_row_sharded_preconditioner_operator_sums_over_the_rows(worlds, world, run):
    """The preconditioner's operator P = L L^T + D of the row-sharded train
    operator (pivoted rank 5) maps a vector's rows to the rank's rows of the
    unsharded port's P v, through its product and through its solvers'
    closure: its product sums L_R^T v_R over the model group ("precond")
    once, as CIQ's nested P^{1/2} quadrature needs."""
    results, _ = worlds
    for r in results[world]:
        got = r[run["name"]]["precond_op"]
        _held(got["got"], got["want"], 1e-12)
        _held(got["closure"], got["want"], 1e-12)
        assert got["counts"] == {"precond": 1}, got["counts"]
