"""One rank of a gloo world on the CPU for ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py RANK WORLD PORT SPEC_JSON OUT_DIR

SPEC_JSON lists runs, each a mesh layout and a data set from the ``.npz``
beside it (x (B, n, d), y (B, n), the probe block (B, n, m) every package
draws, the raw parameters).  Each run lays its mesh over the world, runs the
sharded neg_mll and its backward on the rank's block (gradient shares summed
over ``data`` as the training step sums them), the unsharded run of the same
model on the whole data in this process, and one ``sharded_train_step`` with
Adam; it counts CG's iterations, the collectives by name and the kernel
routes (K1, K3).  Runs marked so check that what the mesh does not cover
raises; with "scaling" in SPEC, ``scaling_report`` runs on meshes of 2 and 4
ranks.  A "serve" run takes its data set's x, y, x_star, rhs and w and, on
its mesh, runs the sharded neg_mll and its gradient under each
preconditioner mode and on the Cholesky route, ``solve`` and its gradient,
``posterior`` and its gradient (beside the unsharded port's), and
``posterior_cache`` with ``posterior_from_cache`` (its SERVE settings),
counting the collectives and the rows of every gathered block.  The rank
writes ``OUT_DIR/rank<RANK>.json``.  Imports no JAX.
"""

import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import linear_operator_tpu_torch as lo  # noqa: E402
from linear_operator_tpu_torch import settings  # noqa: E402
from linear_operator_tpu_torch.operators import kernel as tkernel  # noqa: E402
from linear_operator_tpu_torch.ops.rbf import kernel_matvec_plain  # noqa: E402
from linear_operator_tpu_torch.parallel import _comm, make_mesh, shard_gp_batch, sharded_train_step  # noqa: E402
from linear_operator_tpu_torch.parallel.sharding import initialize_distributed  # noqa: E402

# test_models_parallel.py's settings: CG + SLQ, never Cholesky, no preconditioner
SETTINGS = dict(max_cholesky_size=0, num_trace_samples=4, max_cg_iterations=30, cg_tolerance=1e-6,
                min_preconditioning_size=10**9)
LR = 0.01
# the serving cases: the settings each runs under (on top of SETTINGS'
# probes and CG cap), shared with the JAX references of the test
SERVE = {
    "pivoted": dict(max_cholesky_size=0, min_preconditioning_size=16, max_preconditioner_size=5,
                    preconditioner_mode="pivoted"),
    "nystrom": dict(max_cholesky_size=0, min_preconditioning_size=16, max_preconditioner_size=8,
                    preconditioner_mode="nystrom"),
    "auto": dict(max_cholesky_size=0, min_preconditioning_size=16, preconditioner_mode="auto"),
    "cholesky": dict(max_cholesky_size=800, min_preconditioning_size=16),
    "solve": dict(max_cholesky_size=0, min_preconditioning_size=16, max_preconditioner_size=5,
                  cg_tolerance=1e-11, max_cg_iterations=200),
    "posterior": dict(max_cholesky_size=0, min_preconditioning_size=16, max_preconditioner_size=5,
                      cg_tolerance=1e-11, max_cg_iterations=200),
    "cache": dict(max_cholesky_size=0, min_preconditioning_size=16, max_preconditioner_size=5,
                  cg_tolerance=1e-11, max_cg_iterations=200),
}


class _Iterations(logging.Handler):
    def __init__(self):
        super().__init__()
        self.iters = []

    def emit(self, record):
        if record.getMessage().startswith("linear_cg finished"):
            self.iters.append(int(record.args[0]))


def _settings(**over):
    ctxs = [getattr(settings, k)(v) for k, v in {**SETTINGS, **over}.items()] + [settings.verbose_linalg(True)]

    class Both:
        def __enter__(self):
            for c in ctxs:
                c.__enter__()

        def __exit__(self, *exc):
            for c in reversed(ctxs):
                c.__exit__(*exc)

    return Both()


def _model(run, arrays, dtype):
    model = lo.ExactGPRegression(use_fused_kernels=run["fused"], materialize_threshold=None, block_rows=8,
                                 dtype=dtype, device="cpu")
    with torch.no_grad():
        for name, value in zip(("raw_lengthscale", "raw_outputscale", "raw_noise"), arrays["params"]):
            getattr(model, name).fill_(float(value))
    return model


def _grads(model):
    return [float(p.grad) for p in (model.raw_lengthscale, model.raw_outputscale, model.raw_noise)]


def _serve(run, arrays, mesh, log, gathered):
    """The serving cases on the rank's block: results (the rank's batch;
    the rhs gradient its rows) and, per case, the collectives, the CG
    iterations and the (rows, columns) of every gathered block."""
    x, y, x_star, rhs, w = (torch.from_numpy(arrays[k]) for k in ("x", "y", "x_star", "rhs", "w"))
    xs, ys = shard_gp_batch(mesh, x, y)
    x_star = mesh.block(x_star, batch=True, rows=False, cols=False)
    rhs_r = mesh.block(rhs, batch=True, rows=True, cols=False).clone().requires_grad_(True)
    w_r = mesh.block(w, batch=True, rows=True, cols=False)
    model_group, data_group = mesh.group("model"), mesh.group("data")
    out = {}
    for case, over in SERVE.items():
        model = _model(run, arrays, torch.float64)
        log.iters.clear()
        gathered.clear()
        _comm.reset_counts()
        res = {}
        with _settings(**over), mesh:
            if case in ("pivoted", "nystrom", "auto", "cholesky"):
                loss = model.neg_mll(xs, ys, generator=torch.Generator())
                res["counts"], res["gathered"] = dict(_comm.counts), list(gathered)
                loss.backward()
                res["loss"] = float(loss)
            elif case == "solve":
                sol = model.train_operator(xs).solve(rhs_r)
                res["counts"], res["gathered"] = dict(_comm.counts), list(gathered)
                loss = _comm.sum_shares(torch.sum(sol * w_r), model_group)
                loss.backward()
                res["loss"] = float(_comm.all_reduce(loss.detach(), data_group))
                res["rhs_grad"] = rhs_r.grad.tolist()
            elif case == "posterior":
                mean, var = model.posterior(xs, ys, x_star)
                res["counts"], res["gathered"] = dict(_comm.counts), list(gathered)
                res["mean"], res["var"] = mean.tolist(), var.tolist()
                torch.sum(mean + var).backward()
                shares = torch.tensor(_grads(model), dtype=torch.float64)
                res["grads"] = _comm.all_reduce(shares, data_group).tolist()
            else:
                cache = model.posterior_cache(xs, ys, generator=torch.Generator())
                built = dict(_comm.counts)
                res["gathered"] = list(gathered)
                res["mean"], res["var"] = (t.tolist() for t in model.posterior_from_cache(xs, cache, x_star))
                res["counts"] = built
                res["query_counts"] = {k: v - built.get(k, 0) for k, v in _comm.counts.items()
                                       if v > built.get(k, 0)}
                res["root_rows"] = cache.root_inv.shape[-2]
        if "loss" in res:
            shares = torch.tensor(_grads(model), dtype=torch.float64)
            res["grads"] = _comm.all_reduce(shares, data_group).tolist()
        res["iters"] = list(log.iters)
        if case == "posterior":
            # the unsharded port's gradient of the same sum on the whole data
            ref = _model(run, arrays, torch.float64)
            with _settings(**over):
                mean, var = ref.posterior(x, y, torch.from_numpy(arrays["x_star"]))
            torch.sum(mean + var).backward()
            res["ref_grads"] = _grads(ref)
        out[case] = res
    return out


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec = json.loads(Path(sys.argv[4]).read_text())
    data = np.load(spec["arrays"])
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=60)

    probes_by_shape = {}
    real_randn = torch.randn

    def randn(*size, dtype=None, device=None, generator=None):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else tuple(size)
        return torch.from_numpy(probes_by_shape[shape]).to(dtype=dtype, device=device)

    torch.randn = randn
    routes = []

    def sym(x, v, covar):
        routes.append("K3")
        return kernel_matvec_plain(x, x, v, covar)

    def rect(x1, x2, v, covar):
        routes.append("K1")
        return kernel_matvec_plain(x1, x2, v, covar)

    tkernel.kernel_matvec_sym, tkernel.kernel_matvec = sym, rect
    gathered = []
    gather_rows = _comm.all_gather_rows

    def recorded_gather(t, group, sizes):
        if group is not None:
            gathered.append(list(t.shape[-2:]))
        return gather_rows(t, group, sizes)

    _comm.all_gather_rows = recorded_gather
    log = _Iterations()
    logging.getLogger("linear_operator_tpu_torch").setLevel(logging.DEBUG)
    logging.getLogger("linear_operator_tpu_torch").addHandler(log)

    results = {}
    for run in spec["runs"]:
        if run.get("serve"):
            arrays = {k: data[f"{run['case']}_{k}"] for k in ("x", "y", "x_star", "rhs", "w", "params")}
            probes_by_shape.clear()
            for key in data.files:
                if key.startswith(f"{run['case']}_draw"):
                    probes_by_shape[data[key].shape] = data[key]
            layout = run["layout"]
            mesh = make_mesh(None, data=layout[0], model=layout[1], probe=layout[2], device="cpu")
            results[run["name"]] = _serve(run, arrays, mesh, log, gathered)
            continue
        arrays = {k: data[f"{run['case']}_{k}"] for k in ("x", "y", "probes", "params")}
        dtype = torch.float64 if run["dtype"] == "float64" else torch.float32
        x, y = (torch.from_numpy(arrays[k]).to(dtype) for k in ("x", "y"))
        probes_by_shape.clear()
        probes_by_shape[arrays["probes"].shape] = arrays["probes"]
        layout = run["layout"]
        mesh = make_mesh(None, data=layout[0], model=layout[1], probe=layout[2], device="cpu")
        xs, ys = shard_gp_batch(mesh, x, y)
        out = {"rows": xs.shape[1], "batch": xs.shape[0]}

        # the unsharded run of the same model on the whole data
        ref = _model(run, arrays, dtype)
        log.iters.clear()
        with _settings():
            loss = ref.neg_mll(x, y, generator=torch.Generator())
        loss.backward()
        out.update(ref_loss=float(loss), ref_grads=_grads(ref), ref_iters=list(log.iters))

        # the sharded run: loss, gradient shares summed over data
        model = _model(run, arrays, dtype)
        log.iters.clear()
        routes.clear()
        _comm.reset_counts()
        with _settings(), mesh:
            loss = model.neg_mll(xs, ys, generator=torch.Generator())
        forward_counts = dict(_comm.counts)
        forward_routes = list(routes)
        loss.backward()
        shares = torch.tensor(_grads(model), dtype=dtype)
        total = _comm.all_reduce(shares, mesh.group("data"))
        out.update(loss=float(loss), grads=total.tolist(), iters=list(log.iters), counts=forward_counts,
                   backward_counts={k: v - forward_counts.get(k, 0) for k, v in _comm.counts.items()},
                   routes=forward_routes, backward_routes=routes[len(forward_routes):])

        # one training step with Adam
        model = _model(run, arrays, dtype)
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        step = sharded_train_step(model, opt, mesh)
        with _settings():
            step_loss = step(xs, ys, generator=torch.Generator())
        out.update(step_loss=float(step_loss), step_grads=_grads(model),
                   step_params=[float(p) for p in (model.raw_lengthscale, model.raw_outputscale, model.raw_noise)])

        if run.get("raises"):
            raised = {}
            other = lo.DenseLinearOperator(torch.eye(x.shape[1], dtype=dtype).expand(xs.shape[0], -1, -1))
            for label, over, call in [
                ("x gradient", {}, lambda m: m.neg_mll(xs.clone().requires_grad_(True), ys)),
                ("indexing", {}, lambda m: m.train_operator(xs)[..., :3, :3]),
                ("cat_rows", {}, lambda m: m.train_operator(xs).cat_rows(xs[..., :3, :1], ys[..., :1, None])),
                ("sum", {}, lambda m: m.train_operator(xs) + other),
                ("blocked pivoted sweep", dict(min_preconditioning_size=0, max_preconditioner_size=5,
                                               pivoted_cholesky_block_size=2), lambda m: m.neg_mll(xs, ys)),
            ]:
                try:
                    with _settings(**over), mesh:
                        call(_model(run, arrays, dtype))
                    raised[label] = "nothing"
                except NotImplementedError as err:
                    raised[label] = str(err)
            out["raised"] = raised
        results[run["name"]] = out

    torch.randn = real_randn
    if spec.get("scaling"):
        # meshes of 2 ranks (the other two idle) and of 4, model axis 2
        report = lo.parallel.scaling_report([2, 4], model_axis=2, n=64, reps=1, block_rows=32, device="cpu")
        results["scaling"] = {str(c): r for c, r in report.items()}
    Path(sys.argv[5], f"rank{rank}.json").write_text(json.dumps(results))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
