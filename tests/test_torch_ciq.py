"""The port's contour integral quadrature stack against the JAX package: the
elliptic functions and quadrature, shifted MINRES, ``contour_integral_quad``,
``sqrt_inv_matmul`` and ``sqrt_matmul_ciq`` with their gradients, and
``zero_mean_mvn_samples`` with ``settings.ciq_samples`` on and off.

Inputs come from seeded numpy generators; where both packages draw a random
vector (the range estimate's Lanczos start, the samples' base), the
``same_draws`` fixture of ``test_torch_roots.py`` makes the two draws one
numpy array.  Tolerances, relative to the largest entry (gradients: to the
gradient's norm): the elliptic functions and the quadrature to 1e-12 in f64
and 1e-6 in f32 (the same AGM steps, f32 rounding); MINRES to 1e-8 in f64,
with the iteration count equal to the JAX package's (checked by rerunning the
JAX solver with max_iter set to the port's count, which must change nothing,
and to one less, which must), and ``contour_integral_quad`` on a dense
operator to 1e-8; CIQ and its gradients on a GP's kernel operator on the
blocked path in f64 to 1e-6, and on the fused path in f32 (the kernels'
plain versions here, JAX ``use_pallas=True``) to 1e-3, since MINRES carries
the mat-vec's rounding further than CG (see CASES).  n stays at 300 or
below.
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.solvers.minres import minres as j_minres
from linear_operator_tpu_torch.solvers.minres import minres as t_minres
from test_torch_gp_slice import _Both, _close, _gp_data, _models, _np
from test_torch_roots import same_draws  # noqa: F401  (a fixture)
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

# the modules (each package's ``solvers.contour_integral_quad`` is the function)
jciq = importlib.import_module("linear_operator_tpu.solvers.contour_integral_quad")
tciq = importlib.import_module("linear_operator_tpu_torch.solvers.contour_integral_quad")

RAW = ("raw_lengthscale", "raw_outputscale", "raw_noise")
# (fused, dtype, rtol) of the quadrature on a kernel operator: the blocked
# path in f64, the fused one in f32.  MINRES keeps no orthogonality, and over
# its ~40 iterations here it amplifies the mat-vec's rounding: the port
# against itself with a dense instead of a blocked mat-vec moves by 3e-8 in
# f64, while both lie 1.3e-7 from the exact K^{-1/2} z (MINRES at 1e-7)
CASES = [(False, np.float64, 1e-6), (True, np.float32, 1e-3)]
# the JAX benchmark's config 6 settings at a small size, with the
# preconditioner on ("auto": Nystrom) or off
PRECOND = dict(min_preconditioning_size=0, preconditioner_mode="auto")
NO_PRECOND = dict(max_preconditioner_size=0)


class _Counts(logging.Handler):
    """The iteration counts that minres and linear_cg log under verbose_linalg."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.minres, self.cg = [], []

    def emit(self, record):
        if record.msg.startswith("minres finished"):
            self.minres.append(int(record.args[0]))
        elif record.msg.startswith("linear_cg finished"):
            self.cg.append(int(record.args[0]))


@pytest.fixture
def counts():
    log = logging.getLogger("linear_operator_tpu_torch")
    handler, level = _Counts(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        with tlo.settings.verbose_linalg(True):
            yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


# ---------------------------------------------------------------------------
# The quadrature
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_elliptic_functions_match_jax(dtype, rtol):
    m = np.linspace(1e-4, 1 - 1e-4, 9).astype(dtype)
    _close(tciq.ellipk_agm(torch.from_numpy(m)), jciq.ellipk_agm(jnp.asarray(m)), rtol)
    u = np.linspace(0.01, 3.0, 11).astype(dtype)
    for mm in (m[1], m[4], m[-1]):
        got = tciq.ellipj(torch.from_numpy(u), torch.tensor(mm))
        want = jciq.ellipj(jnp.asarray(u), jnp.asarray(mm))
        for g, w in zip(got, want):
            assert g.dtype == torch.from_numpy(m).dtype
            _close(g, w, rtol)


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 1e-6)])
@pytest.mark.parametrize("lo, hi, q", [(0.05, 30.0, 15), (1e-3, 1e3, 8), (0.9, 1.1, 4)])
def test_ciq_shifts_weights_match_jax(dtype, rtol, lo, hi, q):
    lo, hi = np.asarray(lo, dtype), np.asarray(hi, dtype)
    got = tciq.ciq_shifts_weights(torch.from_numpy(lo), torch.from_numpy(hi), q)
    want = jciq.ciq_shifts_weights(jnp.asarray(lo), jnp.asarray(hi), q)
    for g, w in zip(got, want):
        assert g.shape == (q,) and g.dtype == torch.from_numpy(lo).dtype
        _close(g, w, rtol)


def test_quadrature_is_constant_to_autograd():
    lo = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    shifts, weights = tciq.ciq_shifts_weights(lo, 2.0 * lo, 5)
    assert not shifts.requires_grad and not weights.requires_grad


# ---------------------------------------------------------------------------
# MINRES
# ---------------------------------------------------------------------------


def _spd_batch(seed, n, b):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)) / np.sqrt(n)
    return a @ np.swapaxes(a, -1, -2) + np.linspace(0.2, 1.0, b)[:, None, None] * np.eye(n)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_minres_matches_jax(counts, shifted, precond, batch):
    n = 120
    A = _spd_batch(0, n, 2)[: 1 if not batch else 2].reshape(*batch, n, n)
    rhs = np.random.default_rng(1).normal(size=(*batch, n, 3))
    dinv = 1.0 / np.diagonal(A, axis1=-2, axis2=-1)
    shifts = np.array([0.0, 0.05, 1.0, 7.0]) if shifted else None
    kw = dict(tolerance=1e-7, max_iter=300)

    def j_run(**extra):
        return j_minres(
            lambda v: jnp.asarray(A) @ v, jnp.asarray(rhs),
            shifts=None if shifts is None else jnp.asarray(shifts),
            preconditioner=(lambda v: jnp.asarray(dinv)[..., None] * v) if precond else None, **{**kw, **extra},
        )

    got = t_minres(
        lambda v: torch.from_numpy(A) @ v, torch.from_numpy(rhs),
        shifts=None if shifts is None else torch.from_numpy(shifts),
        preconditioner=(lambda v: torch.from_numpy(dinv)[..., None] * v) if precond else None, **kw,
    )
    want = j_run()
    assert got.shape == want.shape == ((4,) if shifted else ()) + (*batch, n, 3)
    _close(got, want, 1e-8)
    (k,) = counts.minres
    assert 1 < k < kw["max_iter"]
    # the JAX loop ran exactly k iterations: stopped at k it is unchanged,
    # at k - 1 it is not
    assert np.array_equal(_np(j_run(max_iter=k)), _np(want))
    assert not np.array_equal(_np(j_run(max_iter=k - 1)), _np(want))
    # each shifted system is solved: (A + s P) x = rhs, P the preconditioner
    p = np.eye(n) / dinv[..., None] if precond else np.eye(n)
    for i, s in enumerate(shifts if shifted else [0.0]):
        x = _np(got)[i] if shifted else _np(got)
        resid = (A + s * p) @ x - rhs
        assert np.linalg.norm(resid) <= 1e-5 * np.linalg.norm(rhs)


def test_minres_vector_rhs_and_zero_column():
    n = 60
    A = _spd_batch(2, n, 1)[0]
    rhs = np.random.default_rng(3).normal(size=(n, 2))
    rhs[:, 1] = 0.0
    got = t_minres(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(rhs), tolerance=1e-10)
    want = j_minres(lambda v: jnp.asarray(A) @ v, jnp.asarray(rhs), tolerance=1e-10)
    _close(got, want, 1e-8)
    assert float(got[:, 1].abs().max()) == 0.0
    vec = t_minres(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(rhs[:, 0]), tolerance=1e-10)
    _close(vec, np.linalg.solve(A, rhs[:, 0]), 1e-8)


# ---------------------------------------------------------------------------
# contour_integral_quad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("precond", [False, True])
def test_contour_integral_quad_matches_jax(same_draws, inverse, precond):
    n = 150
    A = _spd_batch(4, n, 1)[0]
    rhs = np.random.default_rng(5).normal(size=(n, 2))
    dinv = 1.0 / np.diagonal(A)
    init = same_draws((n,))  # the JAX range estimate draws this shape
    with _Both(minres_tolerance=1e-8, max_cg_iterations=400):
        js, jw = jax.jit(lambda r: jciq.contour_integral_quad(
            lambda v: jnp.asarray(A) @ v, r, num_quad=10, inverse=inverse,
            preconditioner=(lambda v: jnp.asarray(dinv)[:, None] * v) if precond else None,
        ))(jnp.asarray(rhs))
        ts, tshifts, tw = tciq.contour_integral_quad(
            lambda v: torch.from_numpy(A) @ v, torch.from_numpy(rhs), init=torch.from_numpy(init), num_quad=10,
            inverse=inverse, preconditioner=(lambda v: torch.from_numpy(dinv)[:, None] * v) if precond else None,
        )
    assert ts.shape == (10, n, 2)
    _close(tw, jw, 1e-10)
    _close(ts, js, 1e-8)
    if not precond:
        # the weighted sum is K^{-1/2} rhs (K^{1/2} rhs) to the quadrature's accuracy
        evals, evecs = np.linalg.eigh(A)
        power = -0.5 if inverse else 0.5
        exact = evecs @ np.diag(evals**power) @ evecs.T @ rhs
        _close(torch.sum(tw[:, None, None] * ts, dim=0), exact, 1e-6)


# ---------------------------------------------------------------------------
# sqrt_inv_matmul and sqrt_matmul_ciq, on the GP's training operator
# ---------------------------------------------------------------------------


def _setting(precond, **more):
    return {**(PRECOND if precond else NO_PRECOND), "minres_tolerance": 1e-7, "max_cg_iterations": 400,
            "num_contour_quadrature": 12, **more}


def _train_ops(fused, dtype, n=300, seed=20):
    x, _, _ = (a.astype(dtype) for a in _gp_data(seed, n=n))
    jmodel, params, tmodel = _models(fused, dtype)
    return x, jmodel, params, tmodel


@pytest.mark.parametrize("fused, dtype, rtol, precond", [(*CASES[0], False), (*CASES[0], True), (*CASES[1], True)])
def test_ciq_values_and_grads_match_jax(same_draws, counts, fused, dtype, rtol, precond):
    """sqrt_inv_matmul (value, and gradients of sum(w * out) with respect to
    the raw parameters and z) and sqrt_matmul_ciq (value, and gradients of
    sum(out^2)); the JAX side in one jitted call."""
    x, jmodel, params, tmodel = _train_ops(fused, dtype)
    n = x.shape[0]
    rng = np.random.default_rng(21)
    z, w, z2 = (rng.normal(size=(n, t)).astype(dtype) for t in (3, 3, 4))
    same_draws((n,))  # the Lanczos start

    @jax.jit
    def j_all(p, z):
        def inv(p, z):
            return jlo.sqrt_inv_matmul(jmodel.train_operator(p, jnp.asarray(x)), z, key=jax.random.PRNGKey(0))

        def fwd(p):
            K = jmodel.train_operator(p, jnp.asarray(x))
            return jlo.functions.sqrt_matmul_ciq(K, jnp.asarray(z2), key=jax.random.PRNGKey(0))

        out_inv, vjp_inv = jax.vjp(inv, p, z)
        out_fwd, vjp_fwd = jax.vjp(fwd, p)
        # the gradients of sum(w * inv) and of sum(fwd^2)
        return (out_inv, out_fwd), vjp_inv(jnp.asarray(w)), vjp_fwd(2.0 * out_fwd)[0]

    with _Both(**_setting(precond)):
        (want_inv, want_fwd), (j_gp, j_gz), j_gp2 = j_all(params, jnp.asarray(z))
        zt = torch.from_numpy(z).requires_grad_()
        got = tlo.sqrt_inv_matmul(tmodel.train_operator(torch.from_numpy(x)), zt, generator=torch.Generator())
        torch.sum(torch.from_numpy(w) * got).backward()
        # the range estimate: 20 Lanczos steps, or 20 iterations of preconditioned CG
        assert counts.cg == ([20] if precond else [])
        # the forward's solves and the cotangent's, and with the preconditioner
        # the nested quadrature's P^{1/2} after each
        assert len(counts.minres) == (4 if precond else 2)
        grads = [_np(getattr(tmodel, name).grad) for name in RAW]
        tmodel.zero_grad()
        got_fwd = tlo.functions.sqrt_matmul_ciq(tmodel.train_operator(torch.from_numpy(x)), torch.from_numpy(z2))
        torch.sum(got_fwd**2).backward()
    _close(got, want_inv, rtol)
    _close(got_fwd, want_fwd, rtol)
    _close(zt.grad, j_gz, rtol)
    for name, g in zip(RAW, grads):
        ref = _np(getattr(j_gp, name))
        assert abs(g - ref) <= rtol * max(abs(ref), 1e-3), (name, g, ref)
    for name in RAW:
        g, ref = _np(getattr(tmodel, name).grad), _np(getattr(j_gp2, name))
        assert abs(g - ref) <= rtol * max(abs(ref), 1e-3), (name, g, ref)


def test_preconditioned_root_is_exact(same_draws):
    # with the preconditioner on, the result is M z with M M^T = K^{-1}: the
    # rows of M are whitening, so M^T K M = I
    x, _, _, tmodel = _train_ops(False, np.float64, n=80)
    n = x.shape[0]
    same_draws((n,))
    with _Both(**_setting(True, minres_tolerance=1e-10)), torch.no_grad():
        K = tmodel.train_operator(torch.from_numpy(x))
        M = tlo.sqrt_inv_matmul(K, torch.eye(n, dtype=torch.float64))
        _close(M.mT @ K.to_dense() @ M, np.eye(n), 1e-6)
        # and without it, the symmetric inverse root
    with _Both(**_setting(False, minres_tolerance=1e-10)), torch.no_grad():
        M = tlo.sqrt_inv_matmul(K, torch.eye(n, dtype=torch.float64))
        evals, evecs = np.linalg.eigh(_np(K.to_dense()))
        _close(M, evecs @ np.diag(evals**-0.5) @ evecs.T, 1e-6)


def test_sqrt_inv_matmul_with_lhs_matches_jax(same_draws):
    x, jmodel, params, tmodel = _train_ops(False, np.float64, n=150)
    n = x.shape[0]
    rng = np.random.default_rng(22)
    z, lhs = rng.normal(size=(n, 2)), rng.normal(size=(4, n))
    same_draws((n,))
    @jax.jit
    def j_both(p):
        K = jmodel.train_operator(p, jnp.asarray(x))
        return jlo.sqrt_inv_matmul(K, jnp.asarray(z), jnp.asarray(lhs)), jlo.sqrt_inv_matmul(K, jnp.asarray(z[:, 0]))

    with _Both(**_setting(True)):
        want, vec_want = j_both(params)
        got = tlo.sqrt_inv_matmul(tmodel.train_operator(torch.from_numpy(x)), torch.from_numpy(z),
                                  torch.from_numpy(lhs))
        vec = tlo.sqrt_inv_matmul(tmodel.train_operator(torch.from_numpy(x)), torch.from_numpy(z[:, 0]))
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-6)
    _close(vec, vec_want, 1e-6)


def test_backward_reads_the_forwards_settings(same_draws):
    # the backward runs after the settings block has exited, and must use
    # the quadrature and tolerances the forward read
    x, _, _, tmodel = _train_ops(False, np.float64, n=150)
    n = x.shape[0]
    z = np.random.default_rng(25).normal(size=(n, 2))
    same_draws((n,))
    grads = []
    for inside in (True, False):
        tmodel.zero_grad()
        with _Both(**_setting(True, num_contour_quadrature=7, minres_tolerance=1e-9)):
            out = tlo.sqrt_inv_matmul(tmodel.train_operator(torch.from_numpy(x)), torch.from_numpy(z))
            if inside:
                torch.sum(out**2).backward()
        if not inside:
            torch.sum(out**2).backward()
        grads.append([float(getattr(tmodel, name).grad) for name in RAW])
    np.testing.assert_array_equal(grads[0], grads[1])


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ciq", [False, True])
@pytest.mark.parametrize("fused, dtype, rtol", CASES)
def test_zero_mean_mvn_samples_on_a_kernel_operator(same_draws, ciq, fused, dtype, rtol):
    x, jmodel, params, tmodel = _train_ops(fused, dtype, n=200, seed=26)
    with _Both(ciq_samples=ciq, **_setting(True)):
        want = jax.jit(
            lambda p: jmodel.train_operator(p, jnp.asarray(x)).zero_mean_mvn_samples(6, key=jax.random.PRNGKey(0))
        )(params)
        got = tmodel.train_operator(torch.from_numpy(x)).zero_mean_mvn_samples(6, generator=torch.Generator())
    assert got.shape == want.shape == (6, 200)
    _close(got, want, rtol)


@pytest.mark.parametrize("ciq", [False, True])
def test_zero_mean_mvn_samples_on_the_woodbury_operator(same_draws, ciq):
    # the exact U eps1 + sqrt(D) eps2 draw in both packages, CIQ or not
    rng = np.random.default_rng(27)
    U, d = rng.normal(size=(2, 100, 5)) / 10.0, 0.5 + rng.uniform(size=(2, 100))
    j = jlo.operators.LowRankRootLinearOperator(jlo.operators.DenseLinearOperator(jnp.asarray(U))).add_diagonal(
        jnp.asarray(d))
    t = tlo.LowRankRootLinearOperator(tlo.DenseLinearOperator(torch.from_numpy(U))).add_diagonal(torch.from_numpy(d))
    with _Both(ciq_samples=ciq):
        want = j.zero_mean_mvn_samples(7, key=jax.random.PRNGKey(0))
        got = t.zero_mean_mvn_samples(7, generator=torch.Generator())
    assert got.shape == (7, 2, 100)
    _close(got, want, 1e-10)


def test_ciq_samples_have_the_covariance(same_draws):
    # K M z with M M^T = K^{-1}: over the identity as z, (K M)(K M)^T = K
    x, _, _, tmodel = _train_ops(False, np.float64, n=100, seed=28)
    with _Both(**_setting(True, minres_tolerance=1e-10)), torch.no_grad():
        K = tmodel.train_operator(torch.from_numpy(x))
        S = tlo.functions.sqrt_matmul_ciq(K, torch.eye(100, dtype=torch.float64))
    _close(S @ S.mT, K.to_dense(), 1e-6)


def test_fused_ciq_route_takes_k3_at_16_columns_and_k2_in_the_backward(monkeypatch, counts):
    """Route check on the CPU (the kernels' plain versions): CIQ sampling of 16
    draws calls K3 at t = 1 for each of the range estimate's 20 CG
    iterations, at t = 16 once per MINRES iteration and once for the last
    product; no K3 call is wider than 16 columns.  The backward of
    sum(sqrt_inv_matmul(K, z)^2) stacks 15 shifts x 16 columns = 240 into
    one bilinear form: one K1 call and two K2 calls, each of 240 columns."""
    from linear_operator_tpu_torch.ops import rbf as trbf

    calls = []
    for name in ("_kernel_matvec_sym", "_kernel_matvec", "kernel_weighted"):
        real = getattr(trbf, name)
        monkeypatch.setattr(trbf, name, lambda *a, _n=name, _f=real: calls.append((_n, a[-2].shape[-1])) or _f(*a))
    x, _, _ = (torch.from_numpy(a.astype(np.float32)) for a in _gp_data(29, n=300))
    model = tlo.ExactGPRegression(materialize_threshold=None, device="cpu")
    with _Both(ciq_samples=True, minres_tolerance=1e-3, num_contour_quadrature=15, **PRECOND):
        K = model.train_operator(x)
        s = K.zero_mean_mvn_samples(16, generator=torch.Generator().manual_seed(0))
        assert s.shape == (16, 300) and torch.isfinite(s).all()
        # the nested quadrature's P^{1/2} (on the Nystrom operator, no
        # kernel), then the main MINRES
        _, k = counts.minres
        assert counts.cg == [20]
        assert sorted(calls) == sorted([("_kernel_matvec_sym", 1)] * 20 + [("_kernel_matvec_sym", 16)] * (k + 1))
        calls.clear()
        z = torch.randn(300, 16, dtype=torch.float32, generator=torch.Generator().manual_seed(1))
        torch.sum(tlo.sqrt_inv_matmul(model.train_operator(x), z) ** 2).backward()
    sym = [t for name, t in calls if name == "_kernel_matvec_sym"]
    assert max(sym) <= 16
    assert sorted(c for c in calls if c[0] != "_kernel_matvec_sym") == [
        ("_kernel_matvec", 240), ("kernel_weighted", 240), ("kernel_weighted", 240)]
    assert all(torch.isfinite(getattr(model, name).grad) for name in RAW)
