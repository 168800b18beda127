"""The port's ``MultivariateNormal`` and the GP's ``posterior_distribution``
against the JAX package.

Float64 on the CPU from seeded numpy inputs.  The covariances are small
enough for the Cholesky paths (deterministic), except where a test sets
otherwise; where both packages draw normals (``rsample``, a Lanczos start),
the ``same_draws`` fixture of ``test_torch_roots.py`` makes the draws one
numpy array.  Tolerance 1e-10 relative to the largest entry, except the
predictive distribution built from the port's own LOVE cache (CG to the
benchmark's tolerance and a 30-step Lanczos inverse root in each package),
held to 1e-7 as the LOVE tests hold the cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from test_torch_gp_slice import _Both, _close, _gp_data, _models, _np
from test_torch_roots import same_draws  # noqa: F401  (a fixture)
from test_torch_harness_common import _jit, one_torch_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-10


def _spd(seed, n, batch=()):
    a = np.random.default_rng(seed).normal(size=(*batch, n, n)) / np.sqrt(n)
    return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(n)


def _pair(seed, n, batch=()):
    """The same N(mean, cov) in both packages: (JAX, port)."""
    cov = _spd(seed, n, batch)
    mean = np.random.default_rng(seed + 100).normal(size=(*batch, n))
    j = jlo.MultivariateNormal(jnp.asarray(mean), jlo.operators.DenseLinearOperator(jnp.asarray(cov)))
    t = tlo.MultivariateNormal(torch.from_numpy(mean), tlo.DenseLinearOperator(torch.from_numpy(cov)))
    return j, t


@pytest.mark.parametrize("batch", [(), (2,)])
def test_moments_and_log_prob_match_jax(batch):
    j, t = _pair(0, 40, batch)
    assert t.event_shape == j.event_shape and t.batch_shape == tuple(j.batch_shape)
    rng = np.random.default_rng(1)
    values = [rng.normal(size=(*sample_shape, *batch, 40)) for sample_shape in ((), (3,), (2, 3))]
    names = ("covariance_matrix", "variance", "stddev", "loc")
    # the JAX side in one jitted call
    moments, region, log_probs, entropy = _jit(lambda *vs: (
        [getattr(j, name) for name in names], j.confidence_region(), [j.log_prob(v) for v in vs], j.entropy(),
    ))(*map(jnp.asarray, values))
    for name, want in zip(names, moments):
        _close(getattr(t, name), want, RTOL)
    for got, want in zip(t.confidence_region(), region):
        _close(got, want, RTOL)
    for sample_shape, value, want in zip(((), (3,), (2, 3)), values, log_probs):
        got = t.log_prob(torch.from_numpy(value))
        assert got.shape == want.shape == (*sample_shape, *batch)
        _close(got, want, RTOL)
    _close(t.entropy(), entropy, RTOL)
    # a plain tensor covariance is wrapped
    dense = tlo.MultivariateNormal(t.mean, t.covariance_matrix)
    _close(dense.log_prob(torch.from_numpy(value)), want, RTOL)


def test_log_prob_on_the_stochastic_path(same_draws):
    # above the Cholesky cutoff: CG and SLQ on the same probes
    j, t = _pair(2, 60)
    value = np.random.default_rng(3).normal(size=(2, 60))
    with _Both(max_cholesky_size=0, num_trace_samples=8, cg_tolerance=1e-10, max_cg_iterations=200):
        want = _jit(lambda v: j.log_prob(v, key=jax.random.PRNGKey(0)))(jnp.asarray(value))
        got = t.log_prob(torch.from_numpy(value), generator=torch.Generator())
    _close(got, want, 1e-8)


@pytest.mark.parametrize("sample_shape", [(), (5,), (2, 3)])
def test_rsample_matches_jax(same_draws, sample_shape):
    j, t = _pair(4, 30, (2,))
    want = j.rsample(jax.random.PRNGKey(0), sample_shape)
    got = t.rsample(sample_shape, generator=torch.Generator())
    assert got.shape == want.shape == (*sample_shape, 2, 30)
    _close(got, want, RTOL)
    drawn = t.sample(sample_shape, generator=torch.Generator())
    assert not drawn.requires_grad
    _close(drawn, want, RTOL)


def test_rsample_is_reparameterized():
    mean = torch.zeros(20, dtype=torch.float64, requires_grad=True)
    cov = torch.from_numpy(_spd(5, 20)).requires_grad_()
    s = tlo.MultivariateNormal(mean, tlo.DenseLinearOperator(cov)).rsample((4,), generator=torch.Generator())
    torch.sum(s**2).backward()
    assert mean.grad is not None and cov.grad is not None and torch.isfinite(cov.grad).all()


def test_kl_divergence_dense_root_matches_jax():
    (j1, t1), (j2, t2) = _pair(6, 50, (2,)), _pair(7, 50)
    want = _jit(lambda: j1.kl_divergence(j2))()
    got = t1.kl_divergence(t2)
    assert got.shape == (2,)
    _close(got, want, RTOL)
    _close(t1.kl_divergence(t1), np.zeros(2), 1e-8)


def test_kl_divergence_lazy_trace_term_matches_jax():
    # a root with more than 256 columns that is not dense: the trace term
    # streams its columns in blocks of 256 (two here, the last one partial)
    n = 300
    d = np.linspace(0.5, 2.0, n)
    mean1, mean2 = np.zeros(n), np.random.default_rng(8).normal(size=n)
    cov2 = _spd(9, n)
    j1 = jlo.MultivariateNormal(jnp.asarray(mean1), jlo.operators.RootLinearOperator(
        jlo.operators.DiagLinearOperator(jnp.asarray(np.sqrt(d)))))
    t1 = tlo.MultivariateNormal(torch.from_numpy(mean1), tlo.RootLinearOperator(
        tlo.DiagLinearOperator(torch.from_numpy(np.sqrt(d)))))
    j2 = jlo.MultivariateNormal(jnp.asarray(mean2), jlo.operators.DenseLinearOperator(jnp.asarray(cov2)))
    t2 = tlo.MultivariateNormal(torch.from_numpy(mean2), tlo.DenseLinearOperator(torch.from_numpy(cov2)))
    assert type(t1.lazy_covariance_matrix.root_decomposition().root) is tlo.DiagLinearOperator
    got, want = t1.kl_divergence(t2), _jit(lambda: j1.kl_divergence(j2))()
    _close(got, want, RTOL)
    exact = 0.5 * (np.trace(np.linalg.solve(cov2, np.diag(d))) + mean2 @ np.linalg.solve(cov2, mean2) - n
                   + np.linalg.slogdet(cov2)[1] - np.sum(np.log(d)))
    _close(got, exact, 1e-9)


def test_expand_and_add_jitter_match_jax():
    j, t = _pair(10, 25)
    te = t.expand((3,))
    assert te.batch_shape == (3,) and te.mean.shape == (3, 25)
    value = np.random.default_rng(11).normal(size=(3, 25))
    cov, log_prob, jittered = _jit(lambda v: (
        j.expand((3,)).covariance_matrix, j.expand((3,)).log_prob(v), j.add_jitter(0.1).covariance_matrix,
    ))(jnp.asarray(value))
    _close(te.covariance_matrix, cov, RTOL)
    _close(te.log_prob(torch.from_numpy(value)), log_prob, RTOL)
    _close(t.add_jitter(0.1).covariance_matrix, jittered, RTOL)


# ---------------------------------------------------------------------------
# The GP's predictive distribution
# ---------------------------------------------------------------------------

LOVE = dict(max_cholesky_size=0, preconditioner_mode="auto", min_preconditioning_size=0,
            max_cg_iterations=100, cg_tolerance=1.0, max_root_decomposition_size=30)


def _posterior_pair(same_draws, seed=40):
    x, y, x_star = _gp_data(seed, n=300, m=20)
    jmodel, params, tmodel = _models(False, np.float64)
    same_draws((300,))  # the cache's Lanczos start
    args_j = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_star))
    args_t = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(x_star))
    return jmodel, params, tmodel, args_j, args_t


def test_posterior_distribution_from_the_jax_cache(same_draws, monkeypatch):
    """The distribution built over the JAX package's own cache (carried across
    by ``load_jax_cache``) equals the JAX one entry for entry."""
    jmodel, params, tmodel, args_j, args_t = _posterior_pair(same_draws)
    with _Both(**LOVE):
        jcache = _jit(lambda p: jmodel.posterior_cache(p, *args_j[:2], key=jax.random.PRNGKey(0)))(params)
        monkeypatch.setattr(jmodel, "posterior_cache", lambda *a, **k: jcache)
        want, want_cov, want_var = _jit(lambda p: (
            lambda d: (d, d.covariance_matrix, d.variance))(
            jmodel.posterior_distribution(p, *args_j, key=jax.random.PRNGKey(0))))(params)
    cache = tlo.load_jax_cache(tmodel, jax.tree_util.tree_map(np.asarray, jcache))
    monkeypatch.setattr(tmodel, "posterior_cache", lambda *a, **k: cache)
    got = tmodel.posterior_distribution(*args_t)
    assert isinstance(got, tlo.MultivariateNormal)
    _close(got.mean, want.mean, RTOL)
    _close(got.covariance_matrix, want_cov, RTOL)
    _close(got.variance, want_var, RTOL)
    value = np.random.default_rng(41).normal(size=(4, 20))
    _close(got.log_prob(torch.from_numpy(value)), _jit(want.log_prob)(jnp.asarray(value)), RTOL)
    _close(got.rsample((6,), generator=torch.Generator()), want.rsample(jax.random.PRNGKey(1), (6,)), 1e-8)


def test_posterior_distribution_matches_jax(same_draws):
    """End to end, each package building its own LOVE cache from one start
    vector; the downdate root's columns enter only through V V^T."""
    jmodel, params, tmodel, args_j, args_t = _posterior_pair(same_draws, seed=42)
    noise = 0.1 * np.random.default_rng(43).normal(size=(3, 20))

    def jall(p):
        want = jmodel.posterior_distribution(p, *args_j, key=jax.random.PRNGKey(0))
        value = want.mean + jnp.asarray(noise)
        return want, want.covariance_matrix, value, want.log_prob(value)

    with _Both(**LOVE):
        want, want_cov, value, log_prob = _jit(jall)(params)
        got = tmodel.posterior_distribution(*args_t, generator=torch.Generator())
    _close(got.mean, want.mean, 1e-7)
    _close(got.covariance_matrix, want_cov, 1e-7)
    # a draw's log density, and the draw itself (m = 20: the Cholesky root)
    _close(got.log_prob(torch.from_numpy(_np(value))), log_prob, 1e-7)
    _close(got.rsample((4,), generator=torch.Generator()), want.rsample(jax.random.PRNGKey(1), (4,)), 1e-7)
    # the covariance is the prior's less the downdate, with the jitter
    cov = got.lazy_covariance_matrix
    assert isinstance(cov, tlo.AddedDiagLinearOperator)
    assert isinstance(cov.operators[0].operators[1], tlo.ConstantMulLinearOperator)
