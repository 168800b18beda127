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
counting the collectives and the rows of every gathered block.  A "ski" run
takes one data set's x (n, 2), y, x_star, grid and raw parameters and runs
the row-sharded SKI model's neg_mll and gradient under each of SKI_CASES and
its LOVE posterior, with the collectives by name (x's gradient in SKI_X_GRAD's
cases).  A serve run marked "roots" also runs ``_roots``: the predictive
distribution, the roots and their gradients and the blocked pivoted sweep
under ROOTS.  A "dkl" run holds a
small DKL model's sharded neg_mll, its gradients and two
``sharded_train_step`` steps with Adam against the unsharded port on the
whole data.  The f64 exact-GP runs also return the rank's gradient in its
own rows of a trainable x.  The rank writes ``OUT_DIR/rank<RANK>.json``.
Imports no JAX.
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
from linear_operator_tpu_torch.solvers.pivoted_cholesky import blocked_pivoted_cholesky_with_pivots  # noqa: E402

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

# the SKI cases: TestShardedSKI's settings (test_models_parallel.py: 4
# probes, CG to 1e-6 at most 30, no preconditioner, 10 Lanczos steps), then
# the pivoted and Nystrom preconditioners, the blocked pivoted sweep (rank 24,
# block 8), the Cholesky route and LOVE
SKI_CG = dict(max_cholesky_size=0, min_preconditioning_size=10**9, max_lanczos_quadrature_iterations=10)
SKI_CASES = {
    "cg": SKI_CG,
    "pivoted": {**SKI_CG, "min_preconditioning_size": 16, "max_preconditioner_size": 5,
                "preconditioner_mode": "pivoted"},
    "nystrom": {**SKI_CG, "min_preconditioning_size": 16, "max_preconditioner_size": 8,
                "preconditioner_mode": "nystrom"},
    "blocked": {**SKI_CG, "min_preconditioning_size": 16, "max_preconditioner_size": 24,
                "preconditioner_mode": "pivoted", "pivoted_cholesky_block_size": 8},
    "cholesky": {**SKI_CG, "max_cholesky_size": 1000},
    "posterior": {**SKI_CG, "cg_tolerance": 1e-11, "max_cg_iterations": 200},
}
SKI_X_GRAD = ("nystrom", "cholesky")  # the cases whose x requires a gradient
DKL_HIDDEN = (8, 2)
# the roots and the predictive distribution on a serve run (ROADMAP.md queue
# 1 item 3.1): CG and Lanczos above max_cholesky_size on the training set
# (the "cache" case's route), the m x m covariance on the Cholesky route
# below it; the root and the
# inverse root at every n the serve runs take, on the Cholesky route too;
# S draws; the blocked pivoted sweep's rank and block (the JAX tests' sizes,
# tests/solvers/test_lanczos_slq.py:126-136)
ROOTS = dict(max_cholesky_size=16, min_preconditioning_size=16, max_preconditioner_size=5, cg_tolerance=1e-11,
             max_cg_iterations=200)
ROOTS_CHOLESKY = dict(max_cholesky_size=800)
SAMPLES, BLOCK_RANK, BLOCK_SIZE = 2, 24, 8
# the algebra runs (indexing, the sums, mul, cat_rows, a batch expansion) on
# their own data set: CG to 1e-11 (a result with no diagonal has no
# preconditioner; K itself pivoted rank 5); CIQ at test_torch_ciq.py's
# settings, with the preconditioner ("auto": Nystrom) and without
ALGEBRA = dict(max_cholesky_size=0, min_preconditioning_size=16, max_preconditioner_size=5, cg_tolerance=1e-11,
               max_cg_iterations=200)
CIQ = {"precond": dict(min_preconditioning_size=0, preconditioner_mode="auto", minres_tolerance=1e-7,
                       max_cg_iterations=400, num_contour_quadrature=12),
       "plain": dict(max_preconditioner_size=0, minres_tolerance=1e-7, max_cg_iterations=400,
                     num_contour_quadrature=12)}


class _Iterations(logging.Handler):
    def __init__(self):
        super().__init__()
        self.iters, self.minres = [], []

    def emit(self, record):
        if record.getMessage().startswith("linear_cg finished"):
            self.iters.append(int(record.args[0]))
        elif record.getMessage().startswith("minres finished"):
            self.minres.append(int(record.args[0]))


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


def _own(mesh, sizes):
    """This rank's rows of the model group's blocks of ``sizes``."""
    start = sum(sizes[: mesh.index("model")])
    return slice(start, start + sizes[mesh.index("model")])


def _algebra(run, arrays, mesh, log, full):
    """Indexing, the algebra and CIQ on the rank's block of an algebra data
    set (ALGEBRA's settings): per case the results (a row-sharded result's
    whole to_dense and its rows of a product; a replicated one's whole; a
    solve's rows and gradients, shares summed over data) and the
    collectives of its product.  With ``full`` also the sums, mul,
    cat_rows, a batch expansion, CIQ (beside the unsharded port's MINRES
    iterations) and the preconditioner's operator (beside the unsharded
    port's P v)."""
    x, y, w, V, A, x_new, w_cat = (torch.from_numpy(arrays[k]) for k in
                                   ("x", "y", "w", "V", "A", "x_new", "w_cat"))
    idx, idx2, bidx = (torch.from_numpy(arrays[k]) for k in ("idx", "idx2", "bidx"))
    xs, ys = shard_gp_batch(mesh, x, y)
    w_r, V_r, A_r = (mesh.block(t, batch=True, rows=True, cols=False) for t in (w, V, A))
    w_b, w_cat_b, A_b, x_b, V_b = (mesh.block(t, batch=True, rows=False, cols=False) for t in (w, w_cat, A, x, V))
    group, data_group = mesh.group("model"), mesh.group("data")
    out = {}

    def case(name, fn, over=ALGEBRA):
        model = _model(dict(fused=False), arrays, torch.float64)
        log.iters.clear()
        log.minres.clear()
        with _settings(**over), mesh:
            K = model.train_operator(xs)
            _comm.reset_counts()
            res = fn(model, K)
        res.setdefault("counts", dict(_comm.counts))
        res["iters"], res["minres"] = list(log.iters), list(log.minres)
        if any(p.grad is not None for p in model.parameters()):
            res["grads"] = _comm.all_reduce(torch.tensor(_grads(model), dtype=torch.float64), data_group).tolist()
        out[name] = res

    def product(op, v, **more):
        """op's dense values and its product with v, the product's collectives."""
        dense = op.to_dense()
        _comm.reset_counts()
        mv = op._matmul(v)
        return dict(dense=dense.tolist(), mv=mv.tolist(), counts=dict(_comm.counts), type=type(op).__name__,
                    **more)

    def solved(op, rhs_r, weights, unsharded):
        """The rows of op^{-1} rhs and the gradient of sum(w * sol), with
        the solve's collectives and CG iterations (its backward's too)
        beside the unsharded port's on the rank's batch
        (``unsharded(model)``: its operator and rhs)."""
        _comm.reset_counts()
        log.iters.clear()
        sol = op.solve(rhs_r)
        loss = _comm.sum_shares(torch.sum(sol * weights), group)
        loss.backward()
        got = dict(sol=sol.tolist(), solve_counts=dict(_comm.counts), sol_iters=list(log.iters))
        log.iters.clear()
        with _comm_off():
            ref_op, ref_rhs = unsharded(_model(dict(fused=False), arrays, torch.float64))
            torch.sum(ref_op.solve(ref_rhs) * ref_rhs).backward()
        return dict(got, ref_iters=list(log.iters))

    # indexing: a replicated row selection, square and rectangular blocks, the
    # rank's rows of a column selection and of a column slice, a batch
    # element, and pointwise entries
    case("rows", lambda m, K: product(K[..., idx, :], w_b))
    case("square", lambda m, K: product(K[..., 2:20, 2:20], w_b[..., 2:20, :],
                                        symmetric=bool(K[..., 2:20, 2:20].operators[0].symmetric)))
    case("rect", lambda m, K: product(K[..., 2:20, 5:30], w_b[..., 5:30, :]))
    case("cols", lambda m, K: product(K[..., :, idx], w_b[..., idx, :]))
    case("colslice", lambda m, K: product(K[..., :, 3:11], w_b[..., 3:11, :]))
    case("batch", lambda m, K: dict(dense=K[-1].to_dense().tolist(), type=type(K[-1]).__name__))
    case("entries", lambda m, K: dict(pairs=K[..., idx, idx2].tolist(),
                                      batched=K[bidx, idx, idx2].tolist()))
    if not full:
        return out

    # the sums, add_low_rank (without and with a carried root), mul, a
    # constant multiple and a batch expansion
    def root_carrying(K):
        return K.with_factorization(K.root_decomposition(method="cholesky"))

    def low_rank(m, K):
        op = K.add_low_rank(V_r)
        return dict(product(op, w_r), batch_dense=op[-1].to_dense().tolist(),
                    **solved(op, w_r, w_r, lambda r: (r.train_operator(x_b).add_low_rank(V_b), w_b)))

    case("low_rank", low_rank)
    case("root_low_rank", lambda m, K: product(root_carrying(K).add_low_rank(V_r), w_r))

    def sum_op(m, K):
        # (K + K2) + D: D stays outside, so the solve is preconditioned (pivoted rank 5)
        op = K + m.covariance(xs)
        return dict(product(op, w_r), batch_dense=op[-1].to_dense().tolist(), factors=sum_factors(m, op),
                    **solved(op, w_r, w_r, lambda r: (r.train_operator(x_b) + r.covariance(x_b), w_b)))

    def sum_factors(m, op):
        """The sum's Nystrom and blocked pivoted factors (their columns of
        the summed rows from products with unit vectors) beside the rows of
        the unsharded port's: the largest difference, of the largest entry."""
        with _comm_off():
            whole = m.train_operator(x_b) + m.covariance(x_b)
        errs = {}
        for mode, over in (("nystrom", dict(preconditioner_mode="nystrom")),
                           ("blocked", dict(pivoted_cholesky_block_size=2, max_preconditioner_size=6))):
            with _settings(**{**ALGEBRA, **over}), torch.no_grad():
                got = op._build_precond_factor()
                with _comm_off():
                    want = whole._build_precond_factor()[..., _own(mesh, op.sizes), :]
            errs[mode] = float((got - want).abs().max() / want.abs().max())
        return errs

    case("sum_op", sum_op)
    # a dense tensor of the rank's rows, and the whole n x n operator (cut to them)
    case("sum_dense", lambda m, K: product(K + A_r, w_r, whole=(K + lo.DenseLinearOperator(A_b)).to_dense().tolist()))
    case("sum_scalar", lambda m, K: product(K + 0.5, w_r))
    case("mul", lambda m, K: product(K.mul(m.covariance(xs)), w_r))
    case("scaled", lambda m, K: product(K * 2.5 - K, w_r))
    case("expand", lambda m, K: product(K._expand_batch((3, *K.batch_shape)), w_r))

    # cat_rows: the new rows' cross-covariance (the rank's columns) and C
    # = k(x_new, x_new) + s2 I (replicated, off the mesh)
    x_new_b = mesh.block(x_new, batch=True, rows=False, cols=False)

    def appended(m, K, rooted=False, points=xs):
        with _comm_off():
            C = m.covariance(x_new_b).to_dense()
            C = C + torch.nn.functional.softplus(m.raw_noise) * torch.eye(C.shape[-1], dtype=C.dtype)
        cross = m.covariance(x_new_b, points).to_dense()
        # the carried root from a Cholesky factor (root_low_rank's is a root decomposition's)
        return (K.with_factorization(K.cholesky()) if rooted else K).cat_rows(cross, C)

    def cat(m, K):
        op = appended(m, K)
        w_new = w_cat_b[..., _own(mesh, op.sizes), :]
        return dict(product(op, w_new), batch_dense=op[-1].to_dense().tolist(), sizes=list(op.sizes),
                    **solved(op, w_new, w_new, lambda r: (appended(r, r.train_operator(x_b), points=x_b), w_cat_b)))

    case("cat", cat)
    case("cat_root", lambda m, K: product(appended(m, K, rooted=True), w_cat_b[..., _own(
        mesh, tuple(K.sizes[:-1]) + (K.sizes[-1] + x_new.shape[-2],)), :]))

    # CIQ: sqrt_inv_matmul with the gradients of sum(w * out) in the
    # parameters and the rhs (its rows), then the unsharded port's MINRES
    # iterations; the CIQ draws
    def ciq(m, K):
        z = w_r.clone().requires_grad_(True)
        got = lo.sqrt_inv_matmul(K, z, generator=torch.Generator())
        counts = dict(_comm.counts)
        loss = _comm.sum_shares(torch.sum(got * V_r[..., :1]), group)
        loss.backward()
        return dict(out=got.tolist(), z_grad=z.grad.tolist(), counts=counts, backward=_counts_since(counts))

    for label, over in CIQ.items():
        case(f"ciq_{label}", ciq, {**ALGEBRA, **over})
        ref = _model(dict(fused=False), arrays, torch.float64)
        log.minres.clear()
        with _settings(**{**ALGEBRA, **over}):
            b = mesh.block(torch.arange(x.shape[0]), batch=True, rows=False, cols=False)
            z = w[b].clone().requires_grad_(True)
            got = lo.sqrt_inv_matmul(ref.train_operator(x[b]), z, generator=torch.Generator())
            torch.sum(got * V[b][..., :1]).backward()
        out[f"ciq_{label}"]["ref_minres"] = list(log.minres)

    def samples(m, K):
        """CIQ's draws and the gradient of the sum of their squares."""
        with settings.ciq_samples(True):
            s = K.zero_mean_mvn_samples(SAMPLES, generator=torch.Generator())
        counts = dict(_comm.counts)
        _comm.sum_shares(torch.sum(s * s), group).backward()
        return dict(samples=s.tolist(), counts=counts, backward=_counts_since(counts))

    case("ciq_samples", samples, {**ALGEBRA, **CIQ["precond"]})

    # the preconditioner's operator P = L L^T + D on the rank's rows, beside
    # the unsharded port's P v (pivoted rank 5)
    def precond_op(m, K):
        _, P, _ = K.detach()._preconditioner()
        _comm.reset_counts()
        got = P._matmul(w_r)
        counts = dict(_comm.counts)
        closure = P._matmul_closure()(w_r)
        with _comm_off():
            _, P_full, _ = m.train_operator(x_b).detach()._preconditioner()
            want = P_full._matmul(w_b)[..., _own(mesh, K.sizes), :]
        return dict(got=got.tolist(), closure=closure.tolist(), want=want.tolist(), counts=counts)

    case("precond_op", precond_op)
    return out


class _comm_off:
    """Outside the ambient mesh inside a ``with mesh:`` block."""

    def __enter__(self):
        from linear_operator_tpu_torch.parallel import sharding

        self.saved = list(sharding._AMBIENT)
        sharding._AMBIENT.clear()

    def __exit__(self, *exc):
        from linear_operator_tpu_torch.parallel import sharding

        sharding._AMBIENT.extend(self.saved)


def _counts_since(before):
    return {k: v - before.get(k, 0) for k, v in _comm.counts.items() if v > before.get(k, 0)}


def _roots(run, arrays, mesh, gathered):
    """The predictive distribution, the roots and their gradients, and the
    blocked pivoted sweep on the rank's block (ROOTS' settings): every
    result the rank's batch (and, for a root, its rows), gradient shares
    summed over data, and the collectives of each call."""
    x, y, x_star, w, y_star = (torch.from_numpy(arrays[k]) for k in ("x", "y", "x_star", "w", "y_star"))
    xs, ys = shard_gp_batch(mesh, x, y)
    x_star, y_star = (mesh.block(t, batch=True, rows=False, cols=False) for t in (x_star, y_star))
    w_r = mesh.block(w[..., :1], batch=True, rows=True, cols=False)
    iv_r = mesh.block(torch.from_numpy(arrays["iv"]), batch=True, rows=True, cols=False)
    model_group, data_group = mesh.group("model"), mesh.group("data")
    out = {}

    def summed(model):
        return _comm.all_reduce(torch.tensor(_grads(model), dtype=torch.float64), data_group).tolist()

    # posterior_distribution (its cache's collectives are the "cache" serve
    # case's: ROOTS takes the same route at these n)
    model = _model(run, arrays, torch.float64)
    _comm.reset_counts()
    gathered.clear()
    with _settings(**ROOTS), mesh:
        mvn = model.posterior_distribution(xs, ys, x_star, generator=torch.Generator())
        built, built_gathered = dict(_comm.counts), list(gathered)
        cov = mvn.covariance_matrix
        draws = mvn.rsample((SAMPLES,), generator=torch.Generator())
        log_prob = mvn.log_prob(y_star)
        used, before = _counts_since(built), dict(_comm.counts)
        (torch.sum(mvn.mean) + torch.sum(cov)).backward()
    out["distribution"] = dict(mean=mvn.mean.tolist(), cov=cov.tolist(), draws=draws.tolist(),
                               log_prob=log_prob.tolist(), counts=built, gathered=built_gathered, used=used,
                               backward=_counts_since(before), grads=summed(model))

    # the root, its draws, diagonalization and the inverse root (Lanczos),
    # and the root on the Cholesky route: the rank's rows, with the
    # gradient of |R^T w|^2 (|S^T w|^2), a sum over the rows
    for case, over, inverse in (("root", ROOTS, False), ("inv_root", ROOTS, True),
                                ("chol_root", ROOTS_CHOLESKY, False)):
        model = _model(run, arrays, torch.float64)
        res = {}
        with _settings(**over), mesh:
            K = model.train_operator(xs)
            _comm.reset_counts()
            if inverse:
                R = K.root_inv_decomposition(generator=torch.Generator()).root.to_dense()
            else:
                R = K.root_decomposition(generator=torch.Generator()).root.to_dense()
            forward = dict(_comm.counts)
            proj = _comm.sum_shares(torch.sum(R * w_r, dim=-2), model_group)
            before = dict(_comm.counts)
            torch.sum(proj * proj).backward()
            res.update(R=R.tolist(), counts=forward, backward=_counts_since(before), grads=summed(model))
            if case == "root":
                with torch.no_grad():
                    evals, Q = K.diagonalization(generator=torch.Generator())
                    res.update(evals=evals.tolist(), Q=Q.to_dense().tolist(),
                               samples=K.zero_mean_mvn_samples(SAMPLES, generator=torch.Generator()).tolist())
            if case == "inv_root":
                # the symeig route and Lanczos from given start vectors (the
                # best of two by the residual test)
                with torch.no_grad():
                    res["symeig"] = K.root_inv_decomposition(method="symeig").root.to_dense().tolist()
                    res["initial"] = K.root_inv_decomposition(initial_vectors=iv_r).root.to_dense().tolist()
        out[case] = res

    # the blocked pivoted sweep on the rank's first system, unbatched, and
    # the unsharded port's on the whole system
    b = int(torch.tensor_split(torch.arange(x.shape[0]), mesh.size("data"))[mesh.index("data")][0])
    model = _model(run, arrays, torch.float64)
    with mesh:
        K = model.train_operator(xs[0]).detach()
        _comm.reset_counts()
        L, piv = K.pivoted_factor(BLOCK_RANK, BLOCK_SIZE)
        counts = dict(_comm.counts)
    _, ref_piv = blocked_pivoted_cholesky_with_pivots(model.covariance(x[b]).detach(), BLOCK_RANK, None, BLOCK_SIZE)
    out["blocked"] = dict(system=b, L=L.tolist(), pivots=piv.tolist(), ref_pivots=ref_piv.tolist(), counts=counts)
    return out


def _ski(run, arrays, mesh, log, gathered):
    """The row-sharded SKI model on the rank's rows: per SKI case the loss
    and gradient (ls (2,), outputscale, noise), or the posterior's mean and
    variance, with the collectives, CG iterations and gathered blocks."""
    x, y, x_star = (torch.from_numpy(arrays[k]) for k in ("x", "y", "x_star"))
    xs, ys = shard_gp_batch(mesh, x, y)
    out = {"rows": xs.shape[0]}
    for case, over in SKI_CASES.items():
        model = _ski_model(run, arrays)
        log.iters.clear()
        gathered.clear()
        _comm.reset_counts()
        res = {}
        with _settings(**over), mesh:
            if case == "posterior":
                mean, var = model.posterior(xs, ys, x_star, generator=torch.Generator())
                res["mean"], res["var"] = mean.tolist(), var.tolist()
                res["counts"] = dict(_comm.counts)
            else:
                # x's gradient through the interpolation weights
                x_r = xs.clone().requires_grad_(case in SKI_X_GRAD)
                loss = model.neg_mll(x_r, ys, generator=torch.Generator())
                res["counts"] = dict(_comm.counts)
                loss.backward()
                res["loss"] = float(loss)
                res["grads"] = _ski_grads(model)
                res["backward_counts"] = _counts_since(res["counts"])
                if x_r.grad is not None:
                    res["x_grad"] = x_r.grad.tolist()
        res["iters"], res["gathered"] = list(log.iters), list(gathered)
        if case != "posterior":
            # the unsharded port on the whole data set
            ref = _ski_model(run, arrays)
            with _settings(**over):
                loss = ref.neg_mll(x, y, generator=torch.Generator())
            loss.backward()
            res["ref_loss"], res["ref_grads"] = float(loss), _ski_grads(ref)
        out[case] = res
    out["index"] = _ski_index(run, arrays, mesh, x, xs)
    return out


def _ski_index(run, arrays, mesh, x, xs):
    """Indexing the row-sharded SKI operator (its rows' stencils from their
    owners) beside the unsharded port's: each block's largest difference
    from it, as a share of its largest entry, and the collectives."""
    n = x.shape[0]
    idx = torch.tensor(ski_index(n))
    rows = mesh.block(torch.arange(n)[:, None], batch=False, rows=True, cols=False)[:, 0]
    model = _ski_model(run, arrays)
    with _settings(**SKI_CG):
        with mesh:
            K = model.train_operator(xs)
            _comm.reset_counts()
            got = dict(rows=K[idx, :].to_dense(), block=K[2:20, 5:30].to_dense(), cols=K[:, idx].to_dense(),
                       entries=K[idx, idx.flip(0)])
            counts = dict(_comm.counts)
        K = model.train_operator(x)
        want = dict(rows=K[idx, :].to_dense(), block=K[2:20, 5:30].to_dense(), cols=K[:, idx].to_dense()[rows],
                    entries=K[idx, idx.flip(0)])
    errs = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in want}
    return dict(errs=errs, counts=counts, shapes={k: list(v.shape) for k, v in got.items()},
                values={k: v.tolist() for k, v in got.items()})


def ski_index(n: int) -> list:
    """The global row indices that indexing the SKI operators takes (its
    entries pair them with their reverse)."""
    return [0, n - 1, 7, n // 2, 3]


def _ski_model(run, arrays):
    grid = lo.GridSpec(*(torch.from_numpy(arrays[k]) for k in ("mins", "maxs")), tuple(arrays["sizes"]))
    model = lo.SKIGPRegression(grid, run["interp"], dtype=torch.float64, device="cpu")
    with torch.no_grad():
        model.raw_lengthscale.copy_(torch.from_numpy(arrays["ls"]))
        model.raw_outputscale.fill_(float(arrays["params"][1]))
        model.raw_noise.fill_(float(arrays["params"][2]))
    return model


def _ski_grads(model):
    return [*model.raw_lengthscale.grad.tolist(), float(model.raw_outputscale.grad), float(model.raw_noise.grad)]


def _dkl_model(arrays, d_in):
    model = lo.DeepKernelGPRegression(d_in, DKL_HIDDEN, dtype=torch.float64, device="cpu",
                                      materialize_threshold=None, block_rows=8, use_fused_kernels=False)
    layers = [m for m in model.mlp if isinstance(m, torch.nn.Linear)]
    with torch.no_grad():
        for i, layer in enumerate(layers):
            layer.weight.copy_(torch.from_numpy(arrays[f"w{i}"]).T)
            layer.bias.copy_(torch.from_numpy(arrays[f"b{i}"]))
        for name, value in zip(("raw_lengthscale", "raw_outputscale", "raw_noise"), arrays["params"]):
            getattr(model.gp, name).fill_(float(value))
    return model


def _dkl_grads(model):
    """The gradients in the JAX package's layout: each layer's weights
    (in, out), then the biases, then the GP head's."""
    layers = [m for m in model.mlp if isinstance(m, torch.nn.Linear)]
    parts = [layer.weight.grad.T for layer in layers] + [layer.bias.grad for layer in layers]
    parts += [getattr(model.gp, n).grad for n in ("raw_lengthscale", "raw_outputscale", "raw_noise")]
    return torch.cat([p.reshape(-1) for p in parts]).tolist()


def _dkl(run, arrays, mesh, log):
    """DKL on the rank's block: the sharded neg_mll, every gradient (MLP
    shares summed over the mesh as the training step sums them), then two
    ``sharded_train_step`` steps with Adam beside two unsharded Adam steps
    on the whole data."""
    x, y = (torch.from_numpy(arrays[k]) for k in ("x", "y"))
    xs, ys = shard_gp_batch(mesh, x, y)
    d_in = x.shape[-1]
    out = {}
    model = _dkl_model(arrays, d_in)
    _comm.reset_counts()
    log.iters.clear()
    with _settings(), mesh:
        loss = model.neg_mll(xs, ys, generator=torch.Generator())
    forward = dict(_comm.counts)
    loss.backward()
    out.update(loss=float(loss), counts=forward, iters=list(log.iters),
               backward_counts={k: v - forward.get(k, 0) for k, v in _comm.counts.items() if v > forward.get(k, 0)})
    steps = []
    for sharded in (True, False):
        model = _dkl_model(arrays, d_in)
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        if sharded:
            step = sharded_train_step(model, opt, mesh)
        for i in range(2):
            with _settings():
                if sharded:
                    step(xs, ys, generator=torch.Generator())
                else:
                    opt.zero_grad()
                    model.neg_mll(x, y, generator=torch.Generator()).backward()
                    opt.step()
            if i == 0:
                out["step_grads" if sharded else "ref_grads"] = _dkl_grads(model)
        steps.append(torch.cat([p.detach().reshape(-1) for p in model.parameters()]).tolist())
    out["step_params"], out["ref_params"] = steps
    return out


def _x_grad(run, arrays, mesh, xs, ys, dtype):
    """The exact GP's gradient in a trainable x: the rank's rows of its
    batch (shares over data are its own batch's)."""
    model = _model(run, arrays, dtype)
    x_r = xs.clone().requires_grad_(True)
    _comm.reset_counts()
    with _settings(), mesh:
        loss = model.neg_mll(x_r, ys, generator=torch.Generator())
    forward = dict(_comm.counts)
    loss.backward()
    return dict(x_grad=x_r.grad.tolist(), x_grads=_grads(model),
                x_backward_counts={k: v - forward.get(k, 0) for k, v in _comm.counts.items()
                                   if v > forward.get(k, 0)})


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
        if shape not in probes_by_shape:  # a draw the JAX side makes no copy of (DKL's initial MLP)
            return real_randn(shape, dtype=dtype, device=device, generator=generator)
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
        if run.get("algebra"):
            arrays = {k[len(run["case"]) + 1:]: data[k] for k in data.files if k.startswith(run["case"] + "_")}
            probes_by_shape.clear()
            probes_by_shape.update({v.shape: v for k, v in arrays.items() if k.startswith("draw")})
            layout = run["layout"]
            mesh = make_mesh(None, data=layout[0], model=layout[1], probe=layout[2], device="cpu")
            results[run["name"]] = _algebra(run, arrays, mesh, log, run["algebra"] == "full")
            continue
        if run.get("ski") or run.get("dkl"):
            prefix = f"{run['case']}_"
            arrays = {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}
            probes_by_shape.clear()
            probes_by_shape.update({v.shape: v for k, v in arrays.items() if k.startswith("draw")})
            layout = run["layout"]
            mesh = make_mesh(None, data=layout[0], model=layout[1], probe=layout[2], device="cpu")
            results[run["name"]] = (_ski(run, arrays, mesh, log, gathered) if run.get("ski")
                                    else _dkl(run, arrays, mesh, log))
            continue
        if run.get("serve"):
            arrays = {k: data[f"{run['case']}_{k}"] for k in ("x", "y", "x_star", "rhs", "w", "params")}
            probes_by_shape.clear()
            for key in data.files:
                if key.startswith(f"{run['case']}_draw"):
                    probes_by_shape[data[key].shape] = data[key]
            layout = run["layout"]
            mesh = make_mesh(None, data=layout[0], model=layout[1], probe=layout[2], device="cpu")
            results[run["name"]] = _serve(run, arrays, mesh, log, gathered)
            if run.get("roots"):
                arrays.update({k: data[f"{run['case']}_{k}"] for k in ("y_star", "iv")})
                results[run["name"]]["roots"] = _roots(run, arrays, mesh, gathered)
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
        if dtype == torch.float64:
            out.update(_x_grad(run, arrays, mesh, xs, ys, dtype))

        if run.get("raises"):
            raised = {}
            other = lo.DenseLinearOperator(torch.eye(x.shape[1], dtype=dtype).expand(xs.shape[0], -1, -1))
            low_rank = torch.ones((xs.shape[0], xs.shape[1], 1), dtype=dtype)
            for label, over, call in [
                ("posterior_distribution", {}, lambda m: m.posterior_distribution(xs, ys, xs[..., :3, :])),
                ("forward root", {}, lambda m: m.train_operator(xs).root_decomposition()),
                ("indexing", {}, lambda m: m.train_operator(xs)[..., :3, :3]),
                ("cat_rows", {}, lambda m: m.train_operator(xs).cat_rows(0.1 * xs[..., None, :, 0],
                                                                          2.0 + 0.0 * xs[..., :1, :1])),
                ("sum", {}, lambda m: m.train_operator(xs) + other),
                ("blocked pivoted sweep", dict(min_preconditioning_size=0, max_preconditioner_size=5,
                                               pivoted_cholesky_block_size=2), lambda m: m.neg_mll(xs, ys)),
                ("add_low_rank", {}, lambda m: m.train_operator(xs).add_low_rank(low_rank)),
                ("mul", {}, lambda m: m.train_operator(xs).mul(m.train_operator(xs))),
                ("batch expansion", {}, lambda m: m.train_operator(xs)._expand_batch((3, *xs.shape[:-2]))),
                ("sqrt_inv_matmul", {}, lambda m: m.train_operator(xs).sqrt_inv_matmul(ys[..., None])),
                ("CIQ draws", dict(ciq_samples=True), lambda m: m.train_operator(xs).zero_mean_mvn_samples(2)),
            ]:
                try:
                    with _settings(**over), mesh:
                        call(_model(run, arrays, dtype))
                    raised[label] = "nothing"
                except Exception as err:  # noqa: BLE001 (the test reports what failed)
                    raised[label] = f"{type(err).__name__}: {err}"
            out["raised"] = raised
        results[run["name"]] = out

    torch.randn = real_randn
    if spec.get("scaling"):
        # _comm.top over a model group of 4 whose ranks hold fewer rows than
        # k = 10 (11 rows: 3, 3, 3, 2), with ties and buried (-inf) entries
        whole = torch.tensor([1.0, 3.0, 3.0, -torch.inf, 2.0, 3.0, 0.5, 2.0, -torch.inf, 3.0, 2.0])
        mesh = make_mesh(None, data=1, model=4, device="cpu")
        rows = torch.tensor_split(torch.arange(11), 4)[mesh.index("model")]
        index, value, total = _comm.top(whole[rows], 10, mesh.group("model"), int(rows[0]),
                                        torch.tensor([float(len(rows))]))
        results["top"] = dict(index=index.tolist(), value=value.tolist(), total=total.tolist())
        # meshes of 2 ranks (the other two idle) and of 4, model axis 2
        report = lo.parallel.scaling_report([2, 4], model_axis=2, n=64, reps=1, block_rows=32, device="cpu")
        results["scaling"] = {str(c): r for c, r in report.items()}
    Path(sys.argv[5], f"rank{rank}.json").write_text(json.dumps(results))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
