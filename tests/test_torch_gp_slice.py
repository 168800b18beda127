"""The port's exact-GP slice (neg_mll, posterior and their gradients) against
the JAX package, stage by stage and whole.

Stages run in float64 on the blocked (plain) kernel path at rtol 1e-8: both
packages do the same arithmetic, so they differ only by summation order.  The
whole slice is checked in float64 on the blocked path at rtol 1e-7 and in
float32 on the fused path (JAX ``use_pallas=True``, the port's
``use_fused_kernels=True``, whose kernels run their plain versions here) at
rtol 1e-4.  Both sides get identical probe draws by patching each package's
``LowRankRootAddedDiagLinearOperator.zero_mean_mvn_samples`` to return the
same numpy array.  All inputs come from seeded numpy generators.

Gradients (the training step, ``neg_mll(...).backward()`` against
``jax.value_and_grad``) are compared relative to the gradient's norm: in
float64 on the blocked path with ``block_rows=64``, so that both packages take
their per-block backward, at 1e-7; on the fused path in float32 at 1e-4; on
the Cholesky path in float64 at 1e-8.  The JAX gradients are jitted (a tenth
of the eager time on the CPU); the settings are read while tracing, inside the
same settings block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.functions._inv_quad_logdet import _stochastic_iqld as j_stochastic_iqld
from linear_operator_tpu.models.gp import ExactGPRegression as JaxGP
from linear_operator_tpu.operators import kernel as jkernel
from linear_operator_tpu.operators.added_diag import nystrom_factor as j_nystrom
from linear_operator_tpu.operators.low_rank_root_added_diag import (
    LowRankRootAddedDiagLinearOperator as JaxLowRank,
    woodbury_solve_closure as j_woodbury,
)
from linear_operator_tpu.solvers.lanczos import lanczos_tridiag_to_diag as j_tridiag_to_diag
from linear_operator_tpu.solvers.linear_cg import linear_cg as j_linear_cg
from linear_operator_tpu.solvers.stochastic_lq import slq_quadrature as j_slq
from linear_operator_tpu_torch.functions._inv_quad_logdet import _stochastic_iqld as t_stochastic_iqld
from linear_operator_tpu_torch.operators import kernel as tkernel
from linear_operator_tpu_torch.operators.added_diag import nystrom_factor as t_nystrom
from linear_operator_tpu_torch.operators.low_rank_root_added_diag import (
    LowRankRootAddedDiagLinearOperator as TorchLowRank,
    woodbury_solve_closure as t_woodbury,
)
from linear_operator_tpu_torch.solvers.lanczos import lanczos_tridiag_to_diag as t_tridiag_to_diag
from linear_operator_tpu_torch.solvers.linear_cg import linear_cg as t_linear_cg
from linear_operator_tpu_torch.solvers.stochastic_lq import slq_quadrature as t_slq
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol):
    """Entrywise, with errors taken relative to the largest entry."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


class _Both:
    """Enter the same settings in both packages."""

    def __init__(self, **values):
        self.ctxs = [
            getattr(pkg.settings, name)(value)
            for name, value in values.items()
            for pkg in (jlo, tlo)
        ]

    def __enter__(self):
        for c in self.ctxs:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctxs):
            c.__exit__(*exc)


# The slice's settings at a small size: CG + SLQ (never Cholesky) with the
# "auto" Nystrom preconditioner, which gate-keeps on min_preconditioning_size.
SLICE = dict(
    max_cholesky_size=0,
    preconditioner_mode="auto",
    min_preconditioning_size=0,
    num_trace_samples=6,
    max_cg_iterations=100,
    max_lanczos_quadrature_iterations=20,
)


def _gp_data(seed, n=256, d=3, m=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(3.0 * x[:, 0]) + 0.1 * rng.normal(size=n)
    x_star = rng.normal(size=(m, d))
    return x, y, x_star


def _spd(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    return a @ a.T + 0.5 * np.eye(n)


# ---------------------------------------------------------------------------
# Stages, float64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precond", [False, True])
def test_linear_cg_solutions_and_tmats(precond):
    n = 200
    A = _spd(0, n)
    rhs = np.random.default_rng(1).normal(size=(n, 5))
    dinv = 1.0 / np.diag(A)
    kw = dict(tolerance=1e-6, n_tridiag=3, max_iter=60)
    jres = j_linear_cg(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(rhs),
        preconditioner=(lambda v: jnp.asarray(dinv)[:, None] * v) if precond else None, **kw,
    )
    At, dt = torch.from_numpy(A), torch.from_numpy(dinv)
    tres = t_linear_cg(
        lambda v: At @ v, torch.from_numpy(rhs),
        preconditioner=(lambda v: dt[:, None] * v) if precond else None, **kw,
    )
    assert tres.num_iters == int(jres.num_iters)
    _close(tres.solution, jres.solution, 1e-8)
    _close(tres.t_mats, jres.t_mats, 1e-8)
    _close(tres.residual_norm, jres.residual_norm, 1e-6)


def test_linear_cg_identity_pad_and_min_iter():
    # an easy system converges at once, yet CG runs min_iter = 10 iterations
    # for its residual rule and the tridiagonals' unused tail stays identity
    n = 40
    A = np.eye(n) * 2.0
    rhs = np.random.default_rng(2).normal(size=(n, 2))
    kw = dict(n_tridiag=1, max_tridiag_iter=15)
    jres = j_linear_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(rhs), **kw)
    tres = t_linear_cg(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(rhs), **kw)
    assert tres.num_iters == int(jres.num_iters) == 15
    _close(tres.t_mats, jres.t_mats, 1e-12)
    np.testing.assert_array_equal(_np(tres.t_mats)[0, 5:, 5:], np.eye(10))


def test_tridiag_eigs_and_slq():
    rng = np.random.default_rng(3)
    n_probes, k = 4, 12
    diag = 2.0 + rng.uniform(size=(n_probes, k))
    off = 0.5 * rng.uniform(size=(n_probes, k - 1))
    T = np.stack([np.diag(a) + np.diag(b, 1) + np.diag(b, -1) for a, b in zip(diag, off)])
    je, jv = j_tridiag_to_diag(jnp.asarray(T))
    te, tv = t_tridiag_to_diag(torch.from_numpy(T))
    _close(te, je, 1e-8)
    # eigenvector signs are free; SLQ uses the squared first components
    _close(_np(tv)[..., 0, :] ** 2, _np(jv)[..., 0, :] ** 2, 1e-8)
    (jl,) = j_slq(500, je, jv, [jnp.log])
    (tl,) = t_slq(500, te, tv, [torch.log])
    _close(tl, jl, 1e-10)


def test_nystrom_factor():
    x, _, _ = _gp_data(4)
    kw = dict(lengthscale=0.8, outputscale=1.2, materialize_threshold=None)
    jop = jkernel.rbf_kernel_operator(jnp.asarray(x), **kw)
    top = tkernel.rbf_kernel_operator(torch.from_numpy(x), use_fused_kernels=False, **kw)
    _close(t_nystrom(top, 50), j_nystrom(jop, 50), 1e-8)


def test_woodbury_closure_and_logdet():
    rng = np.random.default_rng(5)
    U = rng.normal(size=(150, 20))
    diag = 0.2 + rng.uniform(size=150)
    v = rng.normal(size=(150, 4))
    jc, jld = j_woodbury(jnp.asarray(U), jnp.asarray(diag))
    tc, tld = t_woodbury(torch.from_numpy(U), torch.from_numpy(diag))
    _close(tc(torch.from_numpy(v)), jc(jnp.asarray(v)), 1e-8)
    _close(tld, jld, 1e-10)


def test_stochastic_forward_on_identical_probes():
    x, y, _ = _gp_data(6)
    probes = np.random.default_rng(7).normal(size=(256, 6))
    norms = np.linalg.norm(probes, axis=0, keepdims=True)
    probes = probes / norms
    kw = dict(lengthscale=0.8, outputscale=1.2, materialize_threshold=None)
    jop = jkernel.rbf_kernel_operator(jnp.asarray(x), **kw).add_diagonal(jnp.asarray(0.1))
    top = tkernel.rbf_kernel_operator(torch.from_numpy(x), use_fused_kernels=False, **kw)
    top = top.add_diagonal(torch.tensor(0.1, dtype=torch.float64))
    with _Both(**SLICE):
        jiq, jld = j_stochastic_iqld(
            jop, jnp.asarray(y)[:, None], jnp.asarray(probes), jnp.asarray(probes), jnp.asarray(norms)
        )
        targs = [torch.from_numpy(a) for a in (probes, probes, norms)]
        tiq, tld = t_stochastic_iqld(top, torch.from_numpy(y)[:, None], *targs)
    _close(tiq, jiq, 1e-8)
    _close(tld, jld, 1e-8)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------


@pytest.fixture
def same_probes(monkeypatch):
    """Both packages' preconditioner draws return one numpy array (one per
    shape: (num_samples, *batch, n))."""

    def install(dtype):
        state = {}

        def draws(num_samples, batch, n):
            shape = (num_samples, *batch, n)
            if shape not in state:
                state[shape] = np.random.default_rng(8).normal(size=shape).astype(dtype)
            return state[shape]

        def jax_draw(self, num_samples, *, key=None):
            return jnp.asarray(draws(num_samples, tuple(self.batch_shape), self.shape[-1]))

        def torch_draw(self, num_samples, *, generator=None):
            return torch.from_numpy(draws(num_samples, tuple(self.batch_shape), self.shape[-1])).to(self.device)

        monkeypatch.setattr(JaxLowRank, "zero_mean_mvn_samples", jax_draw)
        monkeypatch.setattr(TorchLowRank, "zero_mean_mvn_samples", torch_draw)

    return install


def _models(fused, dtype, block_rows=4096):
    """A JAX model and a port model with the JAX parameters carried across."""
    jdtype = jnp.float32 if dtype == np.float32 else jnp.float64
    jmodel = JaxGP(use_pallas=fused, materialize_threshold=None, block_rows=block_rows)
    params = jmodel.init_params(3, dtype=jdtype)._replace(
        raw_lengthscale=jnp.asarray(-0.3, jdtype), raw_noise=jnp.asarray(-1.5, jdtype)
    )
    tmodel = tlo.ExactGPRegression(
        use_fused_kernels=fused, materialize_threshold=None, device="cpu", block_rows=block_rows,
        dtype=torch.float32 if dtype == np.float32 else torch.float64,
    )
    tlo.load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


CASES = [(False, np.float64, 1e-7), (True, np.float32, 1e-4)]


@pytest.mark.parametrize("fused, dtype, rtol", CASES)
def test_neg_mll_matches_jax(same_probes, fused, dtype, rtol):
    same_probes(dtype)
    x, y, _ = (a.astype(dtype) for a in _gp_data(9))
    jmodel, params, tmodel = _models(fused, dtype)
    with _Both(**SLICE):
        want = jmodel.neg_mll(params, jnp.asarray(x), jnp.asarray(y), key=jax.random.PRNGKey(0))
        got = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y), generator=torch.Generator())
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol)


@pytest.mark.parametrize("fused, dtype, rtol", CASES)
def test_posterior_matches_jax(same_probes, fused, dtype, rtol):
    same_probes(dtype)
    x, y, x_star = (a.astype(dtype) for a in _gp_data(10))
    jmodel, params, tmodel = _models(fused, dtype)
    with _Both(**SLICE):
        jmean, jvar = jmodel.posterior(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_star))
        tmean, tvar = tmodel.posterior(*(torch.from_numpy(a) for a in (x, y, x_star)))
    assert tmean.shape == tvar.shape == (24,)
    _close(tmean, jmean, rtol)
    _close(tvar, jvar, rtol)


def test_posterior_wide_solve_takes_k1_and_mll_takes_k3(monkeypatch):
    """Route check on the CPU: the MLL's 11-column solve goes to K3 and the
    posterior's 1 + m = 25-column solve to K1."""
    from linear_operator_tpu_torch.ops.rbf import kernel_matvec_plain

    calls = []

    def sym(x, v, covar):
        calls.append("K3")
        return kernel_matvec_plain(x, x, v, covar)

    def rect(x1, x2, v, covar):
        calls.append("K1")
        return kernel_matvec_plain(x1, x2, v, covar)

    monkeypatch.setattr(tkernel, "kernel_matvec_sym", sym)
    monkeypatch.setattr(tkernel, "kernel_matvec", rect)
    x, y, x_star = (torch.from_numpy(a.astype(np.float32)) for a in _gp_data(11))
    model = tlo.ExactGPRegression(materialize_threshold=None, device="cpu")
    with _Both(**{**SLICE, "num_trace_samples": 10}):
        model.neg_mll(x, y, generator=torch.Generator())
        assert set(calls) == {"K3"}
        calls.clear()
        model.posterior(x, y, x_star)
        assert set(calls) == {"K1"}


# ---------------------------------------------------------------------------
# Gradients: the training step and the posterior
# ---------------------------------------------------------------------------

RAW = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def _grad_close(got, want, rtol):
    """Entrywise, with errors taken relative to the gradient's norm."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.linalg.norm(want))


def _port_grads(tmodel):
    return [_np(getattr(tmodel, name).grad) for name in RAW]


def _jax_grads(g):
    return [_np(getattr(g, name)) for name in RAW]


# (fused, dtype, block_rows, rtol of the gradient's norm)
GRAD_CASES = [(False, np.float64, 64, 1e-7), (True, np.float32, 4096, 1e-4)]


@pytest.mark.parametrize("fused, dtype, block_rows, rtol", GRAD_CASES)
def test_training_step_grads_match_jax(same_probes, fused, dtype, block_rows, rtol):
    """neg_mll(...).backward() against jax.value_and_grad of the JAX model's
    neg_mll on identical probes: the three raw parameters and y (the rhs
    gradient of inv_quad_logdet)."""
    same_probes(dtype)
    x, y, _ = (a.astype(dtype) for a in _gp_data(20))
    jmodel, params, tmodel = _models(fused, dtype, block_rows)
    yt = torch.from_numpy(y).requires_grad_()
    with _Both(**SLICE):
        want, (jg, jgy) = jax.jit(jax.value_and_grad(
            lambda p, yy: jmodel.neg_mll(p, jnp.asarray(x), yy, key=jax.random.PRNGKey(0)), argnums=(0, 1)
        ))(params, jnp.asarray(y))
        loss = tmodel.neg_mll(torch.from_numpy(x), yt, generator=torch.Generator())
        loss.backward()
    np.testing.assert_allclose(_np(loss), _np(want), rtol=rtol)
    _grad_close(_port_grads(tmodel), _jax_grads(jg), rtol)
    _grad_close(yt.grad, jgy, rtol)


def test_training_step_grads_cholesky_path():
    """Below max_cholesky_size the port differentiates the dense Cholesky
    through autograd; the JAX package through its Cholesky VJP."""
    x, y, _ = _gp_data(21, n=128)
    jmodel, params, tmodel = _models(False, np.float64)
    with _Both(**{**SLICE, "max_cholesky_size": 1000}):
        want, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y))))(params)
        loss = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
    np.testing.assert_allclose(_np(loss), _np(want), rtol=1e-10)
    _grad_close(_port_grads(tmodel), _jax_grads(jg), 1e-8)


def test_training_step_under_skip_logdet_forward(same_probes):
    """skip_logdet_forward zeroes the SLQ term of the forward value but not
    its gradient: the backward works from the forward's probe solves."""
    same_probes(np.float64)
    x, y, _ = (torch.from_numpy(a) for a in _gp_data(22))
    grads, losses = [], []
    for skip in (False, True):
        tmodel = tlo.ExactGPRegression(use_fused_kernels=False, materialize_threshold=None,
                                       device="cpu", dtype=torch.float64)
        with _Both(**SLICE), tlo.settings.skip_logdet_forward(skip):
            loss = tmodel.neg_mll(x, y, generator=torch.Generator())
            loss.backward()
        grads.append(_port_grads(tmodel))
        losses.append(float(loss.detach()))
    _grad_close(grads[1], grads[0], 1e-12)
    assert losses[0] != losses[1]


@pytest.mark.parametrize("fused, dtype, block_rows, rtol", GRAD_CASES)
def test_posterior_grads_match_jax(fused, dtype, block_rows, rtol):
    """Gradient of sum(mean) + sum(var) through _Solve.backward (one more CG
    solve and one _bilinear_derivative over the 1 + m = 25 columns, which on
    the fused path is K1's backward)."""
    x, y, x_star = (a.astype(dtype) for a in _gp_data(23))
    jmodel, params, tmodel = _models(fused, dtype, block_rows)

    def jloss(p):
        mean, var = jmodel.posterior(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_star))
        return jnp.sum(mean) + jnp.sum(var)

    with _Both(**SLICE):
        jg = jax.jit(jax.grad(jloss))(params)
        mean, var = tmodel.posterior(*(torch.from_numpy(a) for a in (x, y, x_star)))
        (mean.sum() + var.sum()).backward()
    _grad_close(_port_grads(tmodel), _jax_grads(jg), rtol)


def test_solve_grads_match_jax():
    """solve(K, rhs) with K = k(x, x) + noise I: gradients to the rhs and to
    the lengthscale, outputscale and noise tensors, blocked, float64."""
    x, _, _ = _gp_data(24)
    rng = np.random.default_rng(25)
    rhs, w = rng.normal(size=(256, 3)), rng.normal(size=(256, 3))
    hyper = (0.8, 1.2, 0.1)

    def jf(ls, os_, noise, b):
        op = jkernel.rbf_kernel_operator(
            jnp.asarray(x), lengthscale=ls, outputscale=os_, block_rows=64, materialize_threshold=None
        ).add_diagonal(noise)
        return jnp.sum(jlo.solve(op, b) * w)

    leaves = [torch.tensor(h, dtype=torch.float64, requires_grad=True) for h in hyper]
    rt = torch.from_numpy(rhs).requires_grad_()
    with _Both(**SLICE):
        want = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3)))(*(jnp.asarray(h) for h in hyper), jnp.asarray(rhs))
        op = tkernel.rbf_kernel_operator(
            torch.from_numpy(x), lengthscale=leaves[0], outputscale=leaves[1], block_rows=64,
            use_fused_kernels=False, materialize_threshold=None,
        ).add_diagonal(leaves[2])
        torch.sum(tlo.solve(op, rt) * torch.from_numpy(w)).backward()
    _grad_close([t.grad for t in leaves], want[:3], 1e-7)
    _close(rt.grad, want[3], 1e-7)


def test_unbroadcast_matches_jax():
    from linear_operator_tpu.functions._solve import _unbroadcast as j_unbroadcast
    from linear_operator_tpu_torch.functions._solve import _unbroadcast as t_unbroadcast

    g = np.random.default_rng(26).normal(size=(2, 3, 5, 4))
    for shape in [(2, 3, 5, 4), (3, 5, 4), (1, 5, 4), (3, 5, 1), (5, 4)]:
        _close(t_unbroadcast(torch.from_numpy(g), shape), j_unbroadcast(jnp.asarray(g), shape), 1e-12)


def test_bilinear_derivative_per_leaf_and_shared_inputs():
    """K = k(x, x) + D: the term-wise, blocked and base backwards agree with
    autograd through the dense matrix; x1 is x2, and each place gets its own
    partial; the preconditioner factor gets None."""
    rng = np.random.default_rng(27)
    x = torch.from_numpy(rng.normal(size=(100, 3))).requires_grad_()
    ls, os_, noise = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (0.7, 1.3, 0.2))
    left, right = (torch.from_numpy(rng.normal(size=(100, 4))) for _ in range(2))
    for block_rows in (32, 4096):
        op = tkernel.rbf_kernel_operator(
            x, lengthscale=ls, outputscale=os_, block_rows=block_rows,
            use_fused_kernels=False, materialize_threshold=None,
        ).add_diagonal(noise).with_preconditioner(torch.zeros(100, 2, dtype=torch.float64))
        leaves = list(op._leaves())
        assert leaves[0] is leaves[1] is x
        grads = op._bilinear_derivative(left, right)
        assert len(grads) == len(leaves) and grads[-1] is None
        want = torch.autograd.grad(torch.sum(left * (op.to_dense() @ right)), (x, ls, os_, noise))
        _close(grads[0] + grads[1], want[0], 1e-12)
        for got, ref in zip(grads[2:5], want[1:]):
            _close(got, ref, 1e-12)
        # _with_leaves is the inverse of _leaves
        rebuilt = op._with_leaves([t.detach() for t in leaves])
        _close(rebuilt.to_dense(), op.to_dense(), 0)


def test_training_step_routes_through_k3_forward_and_k2_backward(monkeypatch):
    """Route check on the CPU: the fused training step's forward calls K3 once
    per CG iteration; its backward makes two K2 calls, one K3 forward (the
    bilinear form's own mat-vec, which carries the outputscale gradient) and
    no K3 call for the constant right vectors and no K1 call."""
    from linear_operator_tpu_torch.ops import rbf as trbf

    calls = []
    for name in ("_kernel_matvec_sym", "_kernel_matvec", "kernel_weighted"):
        real = getattr(trbf, name)
        monkeypatch.setattr(trbf, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    x, y, _ = (torch.from_numpy(a.astype(np.float32)) for a in _gp_data(28))
    model = tlo.ExactGPRegression(materialize_threshold=None, device="cpu")
    with _Both(**{**SLICE, "num_trace_samples": 10}):
        loss = model.neg_mll(x, y, generator=torch.Generator())
        forward = list(calls)
        calls.clear()
        loss.backward()
    assert set(forward) == {"_kernel_matvec_sym"} and len(forward) >= 10
    assert sorted(calls) == ["_kernel_matvec_sym", "kernel_weighted", "kernel_weighted"]
    assert all(torch.isfinite(getattr(model, name).grad) for name in RAW)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tlo.ExactGPRegression().raw_noise.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlo.ExactGPRegression()


def test_softplus_matches_jax_above_torch_threshold():
    from linear_operator_tpu_torch.models.gp import _softplus

    xs = np.array([-30.0, -2.0, 0.0, 19.0, 25.0, 40.0])
    want = jax.nn.softplus(jnp.asarray(xs)) + 1e-6
    np.testing.assert_allclose(_np(_softplus(torch.from_numpy(xs))), _np(want), rtol=1e-14)


# ---------------------------------------------------------------------------
# The default preconditioner: rank-15 pivoted Cholesky
# ---------------------------------------------------------------------------

# n = 2000 reaches the default min_preconditioning_size, so the pivoted factor
# is built and applied; float64 on the blocked path, as the slice above
PIVOTED = {**SLICE, "preconditioner_mode": "pivoted", "max_preconditioner_size": 15,
           "min_preconditioning_size": 2000}


def test_neg_mll_and_grads_under_pivoted_preconditioner(same_probes):
    same_probes(np.float64)
    x, y, _ = _gp_data(30, n=2000)
    jmodel, params, tmodel = _models(False, np.float64)
    with _Both(**PIVOTED):
        want, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y), key=jax.random.PRNGKey(0))
        ))(params)
        loss = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y), generator=torch.Generator())
        loss.backward()
    np.testing.assert_allclose(_np(loss), _np(want), rtol=1e-7)
    _grad_close(_port_grads(tmodel), _jax_grads(jg), 1e-7)


def test_posterior_under_pivoted_preconditioner():
    x, y, x_star = _gp_data(31, n=2000)
    jmodel, params, tmodel = _models(False, np.float64)
    with _Both(**PIVOTED):
        jmean, jvar = jmodel.posterior(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_star))
        tmean, tvar = tmodel.posterior(*(torch.from_numpy(a) for a in (x, y, x_star)))
    _close(tmean, jmean, 1e-7)
    _close(tvar, jvar, 1e-7)
