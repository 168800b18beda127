"""The port's SVGP models (``models/svgp.py``, ``models/classification.py``)
against the JAX package: SVGP regression, classification (probit and logit)
and Poisson regression.

Seeded numpy inputs go through the jitted JAX model and the port's model
with the JAX parameters carried across (``load_jax_params``), the
variational parameters moved off the prior so that no term is special.
Every value is a closed form or a fixed quadrature in both packages: held
to 1e-10 in float64 (values relative to the largest entry, gradients for
every parameter to their norm), and to 1e-4 in float32.  The properties the
JAX package's own tests assert are held on the port, with
``torch.optim.Adam`` in place of optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu_torch as tlo
from linear_operator_tpu.models import (
    SVGPClassification as JaxClassification,
    SVGPPoissonRegression as JaxPoisson,
    SVGPRegression as JaxSVGP,
    gauss_hermite_expectation as jax_gh,
)
from linear_operator_tpu_torch.models import gauss_hermite_expectation
from linear_operator_tpu_torch.models.svgp import _var_root
from test_torch_gp_slice import _close, _grad_close, _np
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_structure import _jit

F64 = 1e-10
F32 = 1e-4
FIELDS = ("raw_lengthscale", "raw_outputscale", "raw_noise", "z", "var_mean", "var_root_raw")
KINDS = {
    "regression": (JaxSVGP, {}, tlo.SVGPRegression, {}),
    "probit": (JaxClassification, {"likelihood": "probit"}, tlo.SVGPClassification, {"likelihood": "probit"}),
    "logit": (JaxClassification, {"likelihood": "logit"}, tlo.SVGPClassification, {"likelihood": "logit"}),
    "poisson": (JaxPoisson, {}, tlo.SVGPPoissonRegression, {}),
}


def _data(seed, kind, n=80, d=2, m_star=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    f = np.sin(2.0 * x[:, 0]) + 0.1 * rng.normal(size=n)
    if kind in ("probit", "logit"):
        y = (f > 0).astype(np.float64)
    elif kind == "poisson":
        y = rng.poisson(np.exp(1.0 + f)).astype(np.float64)
    else:
        y = f
    return x, y, rng.normal(size=(m_star, d))


def _models(kind, x, m, dtype=np.float64, seed=0):
    jcls, jkw, tcls, tkw = KINDS[kind]
    jmodel = jcls(**jkw)
    rng = np.random.default_rng(seed)
    mean_draw, root_draw = 0.5 * rng.normal(size=m), 0.2 * rng.normal(size=(m, m))

    def jax_params(xx):  # in one jitted call
        params = jmodel.init_params(xx, m)
        return params._replace(
            raw_lengthscale=jnp.asarray(-0.2, dtype), raw_outputscale=jnp.asarray(0.3, dtype),
            raw_noise=jnp.asarray(-1.7, dtype), z=params.z + 0.05, var_mean=jnp.asarray(mean_draw, dtype),
            var_root_raw=(params.var_root_raw + root_draw).astype(dtype),
        )

    params = _jit(jax_params)(jnp.asarray(x, dtype))
    tmodel = tcls(torch.from_numpy(x.astype(dtype)), m, device="cpu", **tkw)
    tlo.load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _grads(tmodel, fields=FIELDS):
    """The port's gradients; a parameter the loss does not reach (the
    classifier's raw_noise) has none, where jax.grad gives zeros."""
    grads = [getattr(tmodel, name).grad for name in fields]
    return np.concatenate([
        np.zeros(getattr(tmodel, name).numel()) if g is None else _np(g).ravel() for name, g in zip(fields, grads)
    ])


def _jax_grads(g, fields=FIELDS):
    return np.concatenate([np.ravel(getattr(g, name)) for name in fields])


@pytest.mark.parametrize("num_data", [None, 1000])
@pytest.mark.parametrize("kind", list(KINDS))
def test_elbo_and_gradients_match_jax(kind, num_data):
    x, y, _ = _data(0, kind)
    jmodel, params, tmodel = _models(kind, x, 16)
    want, jg = _jit(jax.value_and_grad(
        lambda p: jmodel.neg_elbo(p, jnp.asarray(x), jnp.asarray(y), num_data=num_data)))(params)
    loss = tmodel.neg_elbo(torch.from_numpy(x), torch.from_numpy(y), num_data=num_data)
    loss.backward()
    _close(loss, want, F64)
    # the classifier's likelihood leaves raw_noise out: a zero gradient in both
    _grad_close(_grads(tmodel), _jax_grads(jg), F64)
    with torch.no_grad():
        _close(tmodel.kl(), _jit(jmodel.kl)(params), F64)
        _close(tmodel.expected_log_lik(torch.from_numpy(x), torch.from_numpy(y)),
               _jit(lambda p: jmodel.expected_log_lik(p, jnp.asarray(x), jnp.asarray(y)))(params), F64)


@pytest.mark.parametrize("kind", list(KINDS))
def test_predictions_and_their_gradients_match_jax(kind):
    x, _, xs = _data(1, kind)
    jmodel, params, tmodel = _models(kind, x, 16, seed=1)
    predict = {"regression": "posterior", "probit": "predict_proba", "logit": "predict_proba",
               "poisson": "predict_rate"}[kind]

    def jax_total(p):
        out = getattr(jmodel, predict)(p, jnp.asarray(xs))
        out = jnp.stack(out) if isinstance(out, tuple) else out
        return jnp.sum(out), out

    (_, want), jg = _jit(jax.value_and_grad(jax_total, has_aux=True))(params)
    got = getattr(tmodel, predict)(torch.from_numpy(xs))
    got = torch.stack(got) if isinstance(got, tuple) else got
    got.sum().backward()
    _close(got, want, F64)
    fields = [f for f in FIELDS if f != "raw_noise"]
    _grad_close(_grads(tmodel, fields), _jax_grads(jg, fields), F64)
    if kind in ("probit", "logit"):
        labels = tmodel.predict(torch.from_numpy(xs))
        assert labels.dtype == torch.int32
        np.testing.assert_array_equal(_np(labels), np.asarray(_jit(jmodel.predict)(params, jnp.asarray(xs))))


def test_posterior_distribution_matches_jax():
    x, _, xs = _data(2, "regression")
    jmodel, params, tmodel = _models("regression", x, 12, seed=2)
    draws = np.random.default_rng(3).normal(size=(4, xs.shape[0]))

    def jax_parts(p):
        jmvn = jmodel.posterior_distribution(p, jnp.asarray(xs))
        return jmvn.mean, jmvn.lazy_covariance_matrix.to_dense(), jmvn.log_prob(jnp.asarray(draws))

    jmean, jcov, jlog_prob = _jit(jax_parts)(params)
    with torch.no_grad():
        tmvn = tmodel.posterior_distribution(torch.from_numpy(xs))
        mean, var = tmodel.posterior(torch.from_numpy(xs))
        _close(tmvn.mean, jmean, F64)
        _close(tmvn.lazy_covariance_matrix.to_dense(), jcov, F64)
        _close(tmvn.log_prob(torch.from_numpy(draws)), jlog_prob, F64)
        # the marginal variances: the joint's diagonal, less the jitter
        _close(mean, tmvn.mean, F64)
        np.testing.assert_allclose(_np(tmvn.variance), _np(var), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_float32_matches_jax(kind):
    x, y, xs = (a.astype(np.float32) for a in _data(3, kind))
    jmodel, params, tmodel = _models(kind, x, 16, np.float32, seed=3)
    want, jg = _jit(jax.value_and_grad(lambda p: jmodel.neg_elbo(p, jnp.asarray(x), jnp.asarray(y))))(params)
    loss = tmodel.neg_elbo(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss, want, F32)
    _grad_close(_grads(tmodel), _jax_grads(jg), F32)
    jmean, jvar = _jit(lambda p: jmodel.predictive(p, jnp.asarray(xs)))(params)
    with torch.no_grad():
        mean, var = tmodel.predictive(torch.from_numpy(xs))
    _close(mean, jmean, F32)
    _close(var, jvar, F32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_log_probit_matches_scipy_and_jax(dtype):
    """log Phi(z) from z = -30 (Phi underflows in float32) to 8, against
    scipy's log_ndtr in float64: the port's within 1e-14 in float64 and 1e-5
    in float32.  The JAX package's probit (jax.scipy.stats.norm.logcdf) lies
    more than 0.1% off in the upper tail, z >= 5, where log Phi(z) -> 0;
    where |z| <= 4 (the classification tests' range) the packages agree to
    1e-10 in float64."""
    from scipy.special import log_ndtr

    z = np.linspace(-30.0, 8.0, 381).astype(dtype)
    truth = log_ndtr(z.astype(np.float64))
    got = _np(torch.special.log_ndtr(torch.from_numpy(z))).astype(np.float64)
    jax_got = np.asarray(jax.scipy.stats.norm.logcdf(jnp.asarray(z))).astype(np.float64)
    np.testing.assert_allclose(got, truth, rtol=1e-14 if dtype == np.float64 else 1e-5, atol=0)
    assert (np.abs(jax_got - truth) / np.abs(truth))[z >= 5].max() > 1e-3
    if dtype == np.float64:
        inner = np.abs(z) <= 4
        np.testing.assert_allclose(got[inner], jax_got[inner], rtol=1e-10, atol=0)


def test_gauss_hermite_matches_jax_and_the_moments():
    mean = np.array([0.3, -1.2, 2.0])
    var = np.array([0.5, 2.0, 0.1])
    tm, tv = torch.from_numpy(mean), torch.from_numpy(var)
    for q in (10, 20, 40):
        _close(gauss_hermite_expectation(torch.sigmoid, tm, tv, q),
               jax_gh(jax.nn.sigmoid, jnp.asarray(mean), jnp.asarray(var), q), 1e-14)
    np.testing.assert_allclose(_np(gauss_hermite_expectation(lambda f: f, tm, tv)), mean, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(gauss_hermite_expectation(lambda f: f**2, tm, tv)), var + mean**2, rtol=1e-12)


def test_kl_is_the_dense_gaussian_kl():
    x, _, _ = _data(4, "regression", n=30)
    _, _, model = _models("regression", x, 8, seed=4)
    r = _np(_var_root(model.var_root_raw))
    s, mu = r @ r.T, _np(model.var_mean)
    want = 0.5 * (np.trace(s) + mu @ mu - 8 - np.linalg.slogdet(s)[1])
    np.testing.assert_allclose(float(model.kl().detach()), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["regression", "probit"])
def test_minibatch_elbo_is_unbiased(kind):
    """The rescaled data terms of a partition into minibatches average to the
    full data term (the KL is deterministic)."""
    x, y, _ = _data(5, kind, n=60)
    _, _, model = _models(kind, x, 12, seed=5)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        full, kl = float(model.elbo(xt, yt)), float(model.kl())
        parts = [float(model.elbo(xt[s : s + 10], yt[s : s + 10], num_data=60)) + kl for s in range(0, 60, 10)]
    np.testing.assert_allclose(sum(parts) / 6 - kl, full, rtol=1e-10, atol=1e-8)


def _optimal_q(model, x, y):
    """q(u) that maximizes the SVGP ELBO of a Gaussian likelihood at fixed
    hyperparameters and inducing points: S_w = (I + A A^T / s2)^-1 and
    m_w = S_w A y / s2, A = L_zz^-1 K_zx."""
    with torch.no_grad():
        a, _ = model._whitened(x)
        s2 = model._hyp()[2]
        prec = torch.eye(a.shape[0], dtype=a.dtype) + a @ a.mT / s2
        cov = torch.linalg.inv(prec)
        root = torch.linalg.cholesky(cov)
        raw = torch.tril(root, -1) + torch.diag(torch.log(torch.expm1(torch.diagonal(root) - 1e-6)))
        model.var_root_raw.copy_(raw)
        model.var_mean.copy_(cov @ (a @ y) / s2)


def test_optimal_q_reaches_the_collapsed_bound_and_at_m_equal_n_the_exact_gp():
    """At the optimal q the SVGP ELBO equals SGPR's collapsed bound (same
    hyperparameters and inducing points), which stays below the exact MLL;
    with m = n (z = x) the SVGP posterior is the exact GP's."""
    x, y, xs = _data(6, "regression", n=50)
    xt, yt, xst = (torch.from_numpy(a) for a in (x, y, xs))
    svgp = tlo.SVGPRegression(xt, 20, jitter=1e-8, device="cpu")
    sgpr = tlo.SGPRRegression(xt, 20, jitter=1e-8 / float(svgp._hyp()[1].detach()), device="cpu")
    with torch.no_grad():
        elbo0 = float(svgp.elbo(xt, yt))
        collapsed = float(sgpr.elbo(xt, yt))
        with tlo.settings.max_cholesky_size(1000):
            exact_ll = float(-tlo.ExactGPRegression(device="cpu", dtype=torch.float64).neg_mll(xt, yt) * 50)
    _optimal_q(svgp, xt, yt)
    with torch.no_grad():
        elbo1 = float(svgp.elbo(xt, yt))
    assert elbo0 < elbo1 <= collapsed + 1e-9 < exact_ll
    np.testing.assert_allclose(elbo1, collapsed, rtol=1e-9)

    full = tlo.SVGPRegression(xt, 50, jitter=1e-8, device="cpu")
    _optimal_q(full, xt, yt)
    with torch.no_grad():
        mean, var = full.posterior(xst)
        with tlo.settings.max_cholesky_size(1000):
            mean_e, var_e = tlo.ExactGPRegression(device="cpu", dtype=torch.float64).posterior(xt, yt, xst)
    # K_zz's jitter of 1e-8 at a condition number near 1e8: ~1e-6 apart
    np.testing.assert_allclose(_np(mean), _np(mean_e), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(var), _np(var_e), rtol=1e-4, atol=1e-5)


def _train(model, x, y, steps, lr=0.05):
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        model.neg_elbo(x, y).backward()
        opt.step()


def test_training_improves_the_elbo_and_every_parameter_has_a_gradient():
    x, y, _ = _data(7, "regression", n=90)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    model = tlo.SVGPRegression(xt, 30, device="cpu")
    model.neg_elbo(xt, yt).backward()
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all() and float(p.grad.abs().sum()) > 0.0, name
    with torch.no_grad():
        elbo0 = float(model.elbo(xt, yt))
    _train(model, xt, yt, 100)
    with torch.no_grad():
        assert float(model.elbo(xt, yt)) > elbo0


@pytest.mark.parametrize("likelihood", ["probit", "logit"])
def test_training_separates_the_classes(likelihood):
    rng = np.random.default_rng(8)
    x = rng.uniform(-2.0, 2.0, size=(150, 1))
    y = (np.sin(2.0 * x[:, 0]) + 0.1 * rng.normal(size=150) > 0).astype(np.float64)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    model = tlo.SVGPClassification(xt, 20, likelihood=likelihood, device="cpu")
    with torch.no_grad():
        elbo0 = float(model.elbo(xt, yt))
    _train(model, xt, yt, 300)
    with torch.no_grad():
        assert float(model.elbo(xt, yt)) > elbo0
        proba = model.predict_proba(xt)
        assert bool(((proba >= 0) & (proba <= 1)).all())
        acc = float((model.predict(xt) == yt).double().mean())
    assert acc > 0.9, acc


def test_poisson_training_recovers_the_rates():
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(-2, 2, (200, 1)), axis=0)
    rate = np.exp(1.0 + np.sin(2.0 * x[:, 0]))
    xt, yt = torch.from_numpy(x), torch.from_numpy(rng.poisson(rate).astype(np.float64))
    model = tlo.SVGPPoissonRegression(xt, 24, device="cpu")
    with torch.no_grad():
        e0 = float(model.elbo(xt, yt))
    _train(model, xt, yt, 400)
    with torch.no_grad():
        assert float(model.elbo(xt, yt)) > e0 + 10.0
        rel = float(np.mean(np.abs(_np(model.predict_rate(xt)) - rate) / rate))
    assert rel < 0.35, rel


def test_classification_guards():
    x = torch.zeros(10, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="probit"):
        tlo.SVGPClassification(x, 4, likelihood="cauchit", device="cpu")
    if not torch.cuda.is_available():
        for cls in (tlo.SVGPRegression, tlo.SVGPClassification, tlo.SVGPPoissonRegression):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls(x, 4)
