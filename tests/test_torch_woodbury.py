"""The port's exact Woodbury operator (``LowRankRootAddedDiagLinearOperator``),
``ConstantMulLinearOperator``, the base class's algebra and ``utils.qr``
against the JAX package.

Everything runs in float64 on the CPU from seeded numpy inputs: U (n, r)
with N(0, 1/n) entries and a diagonal around 0.5, the JAX benchmark's
config 1 at a small n.  Values are held to 1e-10 relative to the largest
entry (both packages evaluate the same closed forms); gradients through the
exact inv_quad_logdet to 1e-10 of the gradient's norm, and through ``solve``,
whose backward is an unpreconditioned CG in both packages, to 1e-7 with CG
run to 1e-12.  n = 1000 is above ``max_cholesky_size`` (800), where an
operator without the exact structure takes CG and SLQ: the fault tests
watch for ``linear_cg`` in the solver log (``settings.verbose_linalg``).
"""

import logging
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.utils.qr import stable_pinverse as j_pinv, stable_qr as j_qr
from linear_operator_tpu_torch import operators as tops
from linear_operator_tpu_torch.utils.warnings import PerformanceWarning
from test_torch_gp_slice import _Both, _close, _np
from test_torch_roots import same_draws  # noqa: F401  (a fixture)
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

N, RANK, NOISE = 1000, 20, 0.5
RTOL = 1e-10


def _data(batch=(), n=N, r=RANK, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(*batch, n, r)) / np.sqrt(n)
    d = NOISE + 0.1 * rng.uniform(size=(*batch, n))
    y = rng.normal(size=(*batch, n, 2))
    return U, d, y


def _ops(U, d):
    """The same Woodbury operator in both packages: (JAX, port)."""
    j = jlo.operators.LowRankRootLinearOperator(jlo.operators.DenseLinearOperator(jnp.asarray(U))).add_diagonal(
        jnp.asarray(d)
    )
    t = tops.LowRankRootLinearOperator(tops.DenseLinearOperator(torch.from_numpy(U))).add_diagonal(torch.from_numpy(d))
    return j, t


def _dense(U, d):
    return U @ np.swapaxes(U, -1, -2) + np.eye(U.shape[-2]) * d[..., None, :]


class _SolverLog(logging.Handler):
    """The solver names ``settings.record_linalg`` logs under verbose_linalg."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.names = []

    def emit(self, record):
        if record.msg.startswith("Running"):
            self.names.append(record.args[0])


@pytest.fixture
def solver_log():
    log = logging.getLogger("linear_operator_tpu_torch")
    handler, level = _SolverLog(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        with tlo.settings.verbose_linalg(True):
            yield handler.names
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


# ---------------------------------------------------------------------------
# The faults: exact solve and logdet, W + Diag, factorize, the public algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_cholesky_size", [800, 0])
def test_logdet_and_inv_quad_are_exact(solver_log, max_cholesky_size):
    U, d, y = _data()
    j, t = _ops(U, d)
    exact = np.linalg.slogdet(_dense(U, d))[1]
    with _Both(max_cholesky_size=max_cholesky_size):
        j_iq, j_ld = jlo.inv_quad_logdet(j, jnp.asarray(y), logdet=True)
        t_iq, t_ld = tlo.inv_quad_logdet(t, torch.from_numpy(y), logdet=True)
        _, t_only_ld = tlo.inv_quad_logdet(t, None, logdet=True)
        t_only_iq, _ = tlo.inv_quad_logdet(t, torch.from_numpy(y), reduce_inv_quad=False)
    _close(t_ld, j_ld, RTOL)
    _close(t_ld, exact, RTOL)
    _close(t_only_ld, exact, RTOL)
    _close(t_iq, j_iq, RTOL)
    _close(t_only_iq, jlo.inv_quad(j, jnp.asarray(y), reduce_inv_quad=False), RTOL)
    assert "linear_cg" not in solver_log and "lanczos_tridiag" not in solver_log


def test_the_readme_demo_calls(solver_log):
    # the public methods the README's Woodbury demo calls, and the rest of
    # the algebra on the same operator
    U, d, y = _data()
    j, t = _ops(U, d)
    yt = torch.from_numpy(y)
    _close(t.solve(yt), jlo.solve(j, jnp.asarray(y)), RTOL)
    for got, want in zip(t.inv_quad_logdet(yt, logdet=True), jlo.inv_quad_logdet(j, jnp.asarray(y), logdet=True)):
        _close(got, want, RTOL)
    _close(t.logdet(), j.logdet(), RTOL)
    _close(t.inv_quad(yt), j.inv_quad(jnp.asarray(y)), RTOL)
    assert "linear_cg" not in solver_log


@pytest.mark.parametrize("max_cholesky_size", [800, 0])
def test_solve_is_exact(solver_log, max_cholesky_size):
    U, d, y = _data()
    j, t = _ops(U, d)
    with _Both(max_cholesky_size=max_cholesky_size):
        want = jlo.solve(j, jnp.asarray(y))
        got = tlo.solve(t, torch.from_numpy(y))
    _close(got, want, RTOL)
    _close(got, np.linalg.solve(_dense(U, d), y), RTOL)
    assert "linear_cg" not in solver_log


def test_adding_a_diagonal_keeps_the_woodbury_structure(solver_log):
    U, d, y = _data()
    j, t = _ops(U, d)
    extra = np.linspace(0.1, 0.2, N)
    for got in (
        t + tops.DiagLinearOperator(torch.from_numpy(extra)),
        tops.DiagLinearOperator(torch.from_numpy(extra)) + t,
        t.add_diagonal(torch.from_numpy(extra)),
        t.operators[0] + tops.DiagLinearOperator(torch.from_numpy(d + extra)),
    ):
        assert type(got) is tops.LowRankRootAddedDiagLinearOperator
        _close(got._diag_op._diagonal(), d + extra, RTOL)
    want = j + jlo.operators.DiagLinearOperator(jnp.asarray(extra))
    assert type(want) is jlo.LowRankRootAddedDiagLinearOperator
    got = t + tops.DiagLinearOperator(torch.from_numpy(extra))
    _close(tlo.inv_quad_logdet(got, None, logdet=True)[1], jlo.inv_quad_logdet(want, None, logdet=True)[1], RTOL)
    # add_jitter goes through the same dispatch
    jittered = t.add_jitter(1e-3)
    assert type(jittered) is tops.LowRankRootAddedDiagLinearOperator
    _close(jittered.to_dense(), j.add_jitter(1e-3).to_dense(), RTOL)
    assert "linear_cg" not in solver_log


def test_factorize_carries_the_cap_factor(solver_log):
    U, d, y = _data()
    j, t = _ops(U, d)
    jf, tf = j.factorize(), t.factorize()
    assert t.cap_chol is None and tf.cap_chol is not None
    _close(tf.cap_chol, jf.cap_chol, RTOL)
    yt = torch.from_numpy(y)
    _close(tf.solve(yt), t.solve(yt), RTOL)
    iq, ld = tf.inv_quad_logdet(yt, logdet=True)
    j_iq, j_ld = jlo.inv_quad_logdet(jf, jnp.asarray(y), logdet=True)
    _close(iq, j_iq, RTOL)
    _close(ld, j_ld, RTOL)
    # the factor is a tensor field: detached, listed and rebuilt with the rest
    leaves = list(tf._leaves())
    assert any(leaf is tf.cap_chol for leaf in leaves)
    assert tf.detach().cap_chol is not None
    rebuilt = tf._with_leaves([2.0 * leaf for leaf in leaves])
    _close(rebuilt.cap_chol, 2.0 * tf.cap_chol, RTOL)
    assert tf._replace(cap_chol=None).cap_chol is None
    # a preconditioner would never be used: with_preconditioner is a no-op
    with tlo.settings.min_preconditioning_size(0), tlo.settings.max_cholesky_size(0):
        assert tf.with_preconditioner() is tf
    assert "linear_cg" not in solver_log


def test_operand_checks():
    U, d, _ = _data(n=50)
    root = tops.LowRankRootLinearOperator(tops.DenseLinearOperator(torch.from_numpy(U)))
    diag = tops.DiagLinearOperator(torch.from_numpy(d))
    with pytest.raises(TypeError):
        tops.LowRankRootAddedDiagLinearOperator(tops.DenseLinearOperator(torch.from_numpy(U @ U.T)), diag)
    with pytest.raises(TypeError):
        tops.LowRankRootAddedDiagLinearOperator(root, root)


@pytest.mark.parametrize("batch, noise_batch", [((3,), (3,)), ((3,), ()), ((2, 3), (3,))])
def test_batched_u_and_noise(batch, noise_batch):
    U, _, y = _data(batch, n=300, seed=1)
    d = NOISE + 0.1 * np.random.default_rng(2).uniform(size=(*noise_batch, 300))
    j, t = _ops(U, d)
    jf, tf = j.factorize(), t.factorize()
    for jo, to in ((j, t), (jf, tf)):
        _close(to.solve(torch.from_numpy(y)), jlo.solve(jo, jnp.asarray(y)), RTOL)
        iq, ld = to.inv_quad_logdet(torch.from_numpy(y), logdet=True)
        j_iq, j_ld = jlo.inv_quad_logdet(jo, jnp.asarray(y), logdet=True)
        _close(iq, j_iq, RTOL)
        _close(ld, j_ld, RTOL)
    _close(t.logdet(), np.linalg.slogdet(_dense(U, np.broadcast_to(d, (*batch, 300))))[1], RTOL)


def test_exact_samples_match_jax(same_draws):
    U, d, _ = _data((2,), n=200, seed=3)
    j, t = _ops(U, d)
    want = j.zero_mean_mvn_samples(5, key=jax.random.PRNGKey(0))
    got = t.zero_mean_mvn_samples(5, generator=torch.Generator().manual_seed(0))
    assert got.shape == (5, 2, 200)
    _close(got, want, RTOL)


# ---------------------------------------------------------------------------
# Gradients with respect to U and the noise
# ---------------------------------------------------------------------------


def _torch_leaves(U, d):
    Ut = torch.from_numpy(U).requires_grad_()
    dt = torch.from_numpy(d).requires_grad_()
    return Ut, dt, tops.LowRankRootLinearOperator(tops.DenseLinearOperator(Ut)).add_diagonal(dt)


def _jax_op(U, d):
    return jlo.operators.LowRankRootLinearOperator(jlo.operators.DenseLinearOperator(U)).add_diagonal(d)


@pytest.mark.parametrize("factorized", [False, True])
def test_inv_quad_logdet_gradients_match_jax(solver_log, factorized):
    U, d, y = _data(n=400, seed=4)

    def j_loss(U, d):
        op = _jax_op(U, d)
        op = op.factorize() if factorized else op
        iq, ld = jlo.inv_quad_logdet(op, jnp.asarray(y), logdet=True)
        return iq + ld

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(U), jnp.asarray(d))
    Ut, dt, op = _torch_leaves(U, d)
    op = op.factorize() if factorized else op
    iq, ld = op.inv_quad_logdet(torch.from_numpy(y), logdet=True)
    (iq + ld).backward()
    for got, w in zip((Ut.grad, dt.grad), want):
        w = _np(w)
        assert np.linalg.norm(_np(got) - w) <= RTOL * np.linalg.norm(w)
    assert "linear_cg" not in solver_log


def test_solve_gradient_runs_cg_in_both_packages(solver_log):
    # the transpose of the Woodbury operator is a plain sum (in both
    # packages), so the solve's backward, K^{-T} g, takes an
    # unpreconditioned CG above the Cholesky cutoff
    U, d, y = _data(n=400, seed=5)
    w = np.random.default_rng(6).normal(size=y.shape)

    def j_loss(U, d):
        return jnp.sum(jlo.solve(_jax_op(U, d), jnp.asarray(y)) * jnp.asarray(w))

    with _Both(max_cholesky_size=0, cg_tolerance=1e-12, max_cg_iterations=400):
        want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(U), jnp.asarray(d))
        Ut, dt, op = _torch_leaves(U, d)
        assert type(op.mT) is tops.SumLinearOperator
        torch.sum(op.solve(torch.from_numpy(y)) * torch.from_numpy(w)).backward()
    assert solver_log == ["linear_cg"]  # the forward solved exactly; only the backward ran CG
    for got, ref in zip((Ut.grad, dt.grad), want):
        ref = _np(ref)
        assert np.linalg.norm(_np(got) - ref) <= 1e-7 * np.linalg.norm(ref)


# ---------------------------------------------------------------------------
# ConstantMulLinearOperator and the base class's algebra
# ---------------------------------------------------------------------------


def _dense_pair(a):
    return jlo.operators.DenseLinearOperator(jnp.asarray(a)), tops.DenseLinearOperator(torch.from_numpy(a))


def _spd(seed, n, batch=()):
    a = np.random.default_rng(seed).normal(size=(*batch, n, n)) / np.sqrt(n)
    return a @ np.swapaxes(a, -1, -2) + np.eye(n)


@pytest.mark.parametrize("constant", [2.5, -1.0, np.array([0.5, 3.0])])
def test_constant_mul_matches_jax(constant):
    a = _spd(7, 30, (2,))
    ja, ta = _dense_pair(a)
    jc = jlo.ConstantMulLinearOperator(ja, jnp.asarray(constant))
    tc = tops.ConstantMulLinearOperator(ta, torch.as_tensor(constant))
    rhs = np.random.default_rng(8).normal(size=(2, 30, 4))
    assert tc.shape == jc.shape
    _close(tc.matmul(torch.from_numpy(rhs)), jc.matmul(jnp.asarray(rhs)), RTOL)
    _close(tc._t_matmul(torch.from_numpy(rhs)), jc._t_matmul(jnp.asarray(rhs)), RTOL)
    _close(tc._matmul_closure()(torch.from_numpy(rhs)), jc._matmul(jnp.asarray(rhs)), RTOL)
    _close(tc.to_dense(), jc.to_dense(), RTOL)
    _close(tc.mT.to_dense(), jc.mT.to_dense(), RTOL)
    _close(tc.diagonal(), jc.diagonal(), RTOL)
    _close(tc.mul(2.0).to_dense(), jc.mul(2.0).to_dense(), RTOL)
    assert type(tc.mul(2.0)) is tops.ConstantMulLinearOperator
    _close(tc._expand_batch((3, 2)).to_dense(), jc._expand_batch((3, 2)).to_dense(), RTOL)
    rows, cols = np.array([0, 3, 7]), np.array([1, 3, 29])
    batch_idx = np.array([1, 0, 1])
    _close(
        tc._get_indices(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(batch_idx)),
        jc._get_indices(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(batch_idx)),
        RTOL,
    )


def test_constant_mul_structure_over_a_diagonal():
    d = np.linspace(0.5, 2.0, 40)
    jd, td = jlo.operators.DiagLinearOperator(jnp.asarray(d)), tops.DiagLinearOperator(torch.from_numpy(d))
    jc, tc = jlo.ConstantMulLinearOperator(jd, jnp.asarray(3.0)), tops.ConstantMulLinearOperator(td, 3.0)
    rhs = np.random.default_rng(9).normal(size=(40, 2))
    _close(tc._logdet_structure(), jc._logdet_structure(), RTOL)
    _close(tc._solve_structure(torch.from_numpy(rhs)), jc._solve_structure(jnp.asarray(rhs)), RTOL)
    _close(tc.logdet(), np.sum(np.log(3.0 * d)), RTOL)
    root = tc._root_structure()
    _close(root.to_dense() @ root.to_dense().mT, 3.0 * np.diag(d), RTOL)


def test_algebra_methods_match_jax():
    a, b = _spd(10, 25), _spd(11, 25)
    (ja, ta), (jb, tb) = _dense_pair(a), _dense_pair(b)
    rhs = np.random.default_rng(12).normal(size=(25, 3))
    pairs = [
        (ja - jb, ta - tb),
        (-ja, -ta),
        (2.0 - ja, 2.0 - ta),
        (ja.add(jb, alpha=0.5), ta.add(tb, alpha=0.5)),
        (ja * 3.0, ta * 3.0),
        (3.0 * ja, 3.0 * ta),
        (ja / 4.0, ta / 4.0),
        (ja + jnp.asarray(b), ta + torch.from_numpy(b)),
        (ja.add_jitter(0.1), ta.add_jitter(0.1)),
    ]
    for jo, to in pairs:
        _close(to.to_dense(), jo.to_dense(), RTOL)
    assert type(ta * 3.0) is tops.ConstantMulLinearOperator
    assert type(-ta) is tops.ConstantMulLinearOperator
    # the public solves of any operator (dense: Cholesky at this size)
    _close(ta.solve(torch.from_numpy(rhs)), ja.solve(jnp.asarray(rhs)), RTOL)
    lhs = np.random.default_rng(13).normal(size=(2, 25))
    _close(ta.solve(torch.from_numpy(rhs), torch.from_numpy(lhs)), ja.solve(jnp.asarray(rhs), jnp.asarray(lhs)), RTOL)
    _close(ta.inv_quad(torch.from_numpy(rhs)), ja.inv_quad(jnp.asarray(rhs)), RTOL)
    _close(
        ta.inv_quad(torch.from_numpy(rhs), reduce_inv_quad=False),
        ja.inv_quad(jnp.asarray(rhs), reduce_inv_quad=False),
        RTOL,
    )
    for got, want in zip(ta.inv_quad_logdet(torch.from_numpy(rhs), logdet=True),
                         ja.inv_quad_logdet(jnp.asarray(rhs), logdet=True)):
        _close(got, want, RTOL)
    _close(ta.logdet(), ja.logdet(), RTOL)
    _close(tlo.add_jitter(ta, 0.2).to_dense(), jlo.add_jitter(ja, 0.2).to_dense(), RTOL)
    _close(tlo.add_diagonal(ta, torch.ones(25)).to_dense(), jlo.add_diagonal(ja, jnp.ones(25)).to_dense(), RTOL)
    _close(tlo.inv_quad(ta, torch.from_numpy(rhs)), jlo.inv_quad(ja, jnp.asarray(rhs)), RTOL)


def test_algebra_refuses_what_is_not_ported():
    a = _spd(14, 10)
    _, ta = _dense_pair(a)
    # the Hadamard product is ported now (tests/test_torch_algebra.py); what a
    # dense operator still refuses, it refuses as the JAX package does
    for fn in ("sqrt", "exp", "log", "abs", "inverse"):
        with pytest.raises(NotImplementedError):
            getattr(ta, fn)()
    with pytest.raises(NotImplementedError):
        ta.solve_triangular(torch.ones(10, 1, dtype=torch.float64), upper=False)
    with pytest.raises(RuntimeError, match="matrix shape"):
        ta.expand(2, 10, 11)


def test_expand_matches_jax():
    a = _spd(15, 12, (1,))
    d = np.linspace(1.0, 2.0, 12)
    ops = [
        _dense_pair(a),
        (jlo.operators.DiagLinearOperator(jnp.asarray(d)), tops.DiagLinearOperator(torch.from_numpy(d))),
        (jlo.operators.RootLinearOperator(jlo.operators.DenseLinearOperator(jnp.asarray(a[0, :, :4]))),
         tops.RootLinearOperator(torch.from_numpy(a[0, :, :4]))),
        (jlo.operators.TriangularLinearOperator(jnp.asarray(np.tril(a))),
         tops.TriangularLinearOperator(torch.from_numpy(np.tril(a)))),
    ]
    ja, ta = ops[0]
    ops.append((ja + ja, ta + ta))
    ops.append((jlo.operators.DiagLinearOperator(jnp.asarray(d)).add_jitter(1.0),
                tops.DiagLinearOperator(torch.from_numpy(d)).add_jitter(1.0)))
    for jo, to in ops:
        got, want = to.expand(3, 12, 12), jo.expand(3, 12, 12)
        assert got.shape == want.shape == (3, 12, 12)
        _close(got.to_dense(), want.to_dense(), RTOL)
        _close(to.expand(2, -1, 12, 12).to_dense(), jo.expand(2, -1, 12, 12).to_dense(), RTOL)
    assert type(ops[1][1].expand(3, 12, 12)) is tops.DiagLinearOperator
    # an operator with no batch structure of its own falls back to dense
    kernel = tops.KernelLinearOperator(
        torch.from_numpy(a[0, :, :2]), torch.from_numpy(a[0, :, :2]),
        {"lengthscale": torch.tensor(1.0, dtype=torch.float64), "outputscale": torch.tensor(1.0, dtype=torch.float64)},
        covar_func=tlo.operators.rbf_covar,
    )
    with pytest.warns(PerformanceWarning):
        expanded = kernel.expand(2, 12, 12)
    _close(expanded.to_dense(), np.broadcast_to(_np(kernel.to_dense()), (2, 12, 12)), RTOL)
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        ops[0][1].expand(2, 12, 12)


# ---------------------------------------------------------------------------
# utils.qr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(30, 8), (2, 30, 8), (8, 30)])
def test_stable_qr_and_pinverse_match_jax(shape):
    from linear_operator_tpu_torch.utils.qr import stable_pinverse as t_pinv, stable_qr as t_qr

    a = np.random.default_rng(16).normal(size=shape)
    tq, tr = t_qr(torch.from_numpy(a))
    _close(tq @ tr, a, RTOL)
    if shape[-2] >= shape[-1]:  # the JAX stable_qr takes tall matrices only
        # QR is unique up to the signs of R's rows
        _close(torch.abs(tr), np.abs(_np(j_qr(jnp.asarray(a))[1])), 1e-8)
    _close(t_pinv(torch.from_numpy(a)), j_pinv(jnp.asarray(a)), 1e-8)
    _close(t_pinv(torch.from_numpy(a)), np.linalg.pinv(a), 1e-8)


def test_stable_qr_bumps_a_dead_diagonal():
    from linear_operator_tpu_torch.utils.qr import stable_pinverse as t_pinv, stable_qr as t_qr

    a = np.random.default_rng(17).normal(size=(20, 5))
    a[:, 3] = a[:, 1]  # rank-deficient: R[3, 3] ~ 0
    _, jr = j_qr(jnp.asarray(a))
    _, tr = t_qr(torch.from_numpy(a))
    got, want = torch.diagonal(tr).abs(), np.abs(np.diagonal(_np(jr)))
    # the dead entry is bumped to 1e-8 max(max|R_ii|, 1), in both packages
    assert want[3] < 1e-7 and abs(float(got[3]) - want[3]) <= 1e-6 * want[3]
    # the live entries before it agree (after it, R is ill-determined)
    _close(got[:3], want[:3], 1e-8)
    assert torch.isfinite(t_pinv(torch.from_numpy(a))).all()
