"""The port's LOVE serving path (``posterior_cache``, ``posterior_from_cache``,
``love_posterior``) against the JAX package.

As in ``test_torch_gp_slice.py``, whose helpers these tests share: float64 on
the blocked path at rtol 1e-7, float32 on the fused path (the kernels' plain
versions here) at rtol 1e-4, relative to the largest entry.  The Lanczos
start vector of both packages is one numpy array (``same_draws`` of
``test_torch_roots.py``); the inverse root, unique only up to its columns'
signs, is compared through R R^T.  The settings are those of the JAX
benchmark's config 3d (CG at cg_tolerance 1.0, the "auto" Nystrom
preconditioner, no Cholesky) at a small size, with k = 30 Lanczos steps.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu_torch as tlo
from linear_operator_tpu_torch.functions import _root_decomposition as t_roots
from linear_operator_tpu_torch.models.gp import love_posterior
from test_torch_gp_slice import _Both, _close, _models, _np
from test_torch_roots import _gram, same_draws  # noqa: F401  (same_draws is a fixture)
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

# the module (the package's ``solvers.linear_cg`` is the function)
t_linear_cg = importlib.import_module("linear_operator_tpu_torch.solvers.linear_cg")

LOVE = dict(
    max_cholesky_size=0,
    preconditioner_mode="auto",
    min_preconditioning_size=0,
    max_cg_iterations=100,
    cg_tolerance=1.0,
    max_root_decomposition_size=30,
)
CASES = [(False, np.float64, 1e-7), (True, np.float32, 1e-4)]


def _data(layout, dtype, n=96, m=16):
    """x (n, d), y (n), x_star (m, d); or two GPs, x (2, n, d), y (2, n),
    x_star (2, m, d)."""
    rng = np.random.default_rng(50)
    batch = (2,) if layout == "batched" else ()
    x = rng.normal(size=(*batch, n, 3))
    y = np.sin(3.0 * x[..., 0]) + 0.1 * rng.normal(size=x.shape[:-1])
    x_star = rng.normal(size=(*batch, m, 3))
    return tuple(a.astype(dtype) for a in (x, y, x_star))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("layout", ["single", "batched"])
@pytest.mark.parametrize("fused, dtype, rtol", CASES)
def test_posterior_cache_and_queries_match_jax(same_draws, fused, dtype, rtol, layout):
    x, y, x_star = _data(layout, dtype)
    jmodel, params, tmodel = _models(fused, dtype)
    with _Both(**LOVE):
        # jitted: a tenth of the eager time on the CPU; the settings and the
        # patched draw are read while tracing, inside this block
        jcache = jax.jit(jmodel.posterior_cache)(params, jnp.asarray(x), jnp.asarray(y))
        jmean, jvar = jax.jit(jmodel.posterior_from_cache)(params, jnp.asarray(x), jcache, jnp.asarray(x_star))
        tx, ty, tx_star = _torch(x, y, x_star)
        cache = tmodel.posterior_cache(tx, ty, generator=torch.Generator())
        tmean, tvar = tmodel.posterior_from_cache(tx, cache, tx_star)
    batch = x.shape[:-2]
    assert cache.alpha.shape == (*batch, 96, 1) and cache.root_inv.shape == (*batch, 96, 30)
    assert tmean.shape == tvar.shape == (*batch, 16)
    _close(cache.alpha, jcache.alpha, rtol)
    _close(_gram(cache.root_inv), _gram(jcache.root_inv), rtol)
    _close(tmean, jmean, rtol)
    _close(tvar, jvar, rtol)
    with torch.no_grad():
        prior = _np(tmodel.covariance(tx_star).diagonal())
    assert (_np(tvar) >= 0).all() and (_np(tvar) <= prior).all()


def test_love_posterior_matches_the_model(same_draws):
    """The module function over the model's operators gives the model's
    cached prediction."""
    x, y, x_star = _torch(*_data("single", np.float64))
    _, _, tmodel = _models(False, np.float64)
    with _Both(**LOVE):
        cache = tmodel.posterior_cache(x, y)
        want = tmodel.posterior_from_cache(x, cache, x_star)
        K = tmodel.train_operator(x).with_preconditioner()
        got = love_posterior(K, tmodel.covariance(x_star, x), y, tmodel.covariance(x_star).diagonal())
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def test_queries_run_no_solve(monkeypatch):
    """posterior_from_cache runs neither CG nor Lanczos: each query batch is
    two products with the cross-covariance."""
    x, y, x_star = _torch(*_data("single", np.float64))
    _, _, tmodel = _models(False, np.float64)
    with _Both(**LOVE):
        cache = tmodel.posterior_cache(x, y, generator=torch.Generator().manual_seed(1))

    def refuse(*args, **kwargs):
        raise AssertionError("a solver ran at query time")

    monkeypatch.setattr(t_linear_cg, "linear_cg", refuse)
    monkeypatch.setattr(t_roots, "lanczos_tridiag", refuse)
    with _Both(**LOVE):
        mean, var = tmodel.posterior_from_cache(x, cache, x_star)
        with pytest.raises(AssertionError, match="a solver ran"):
            tmodel.posterior_cache(x, y)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()


@pytest.mark.parametrize("fused, dtype, rtol", [(False, np.float64, 1e-10), (True, np.float32, 1e-5)])
def test_a_jax_cache_serves_the_jax_queries(fused, dtype, rtol):
    """A cache the JAX package built, carried across with load_jax_cache,
    gives the JAX package's query results."""
    x, y, x_star = _data("single", dtype)
    jmodel, params, tmodel = _models(fused, dtype)
    with _Both(**LOVE):
        jcache = jax.jit(jmodel.posterior_cache)(params, jnp.asarray(x), jnp.asarray(y))
        jmean, jvar = jax.jit(jmodel.posterior_from_cache)(params, jnp.asarray(x), jcache, jnp.asarray(x_star))
    cache = tlo.load_jax_cache(tmodel, jax.tree_util.tree_map(np.asarray, jcache))
    assert isinstance(cache, tlo.PosteriorCache) and cache.root_inv.dtype == tmodel.raw_noise.dtype
    tx, tx_star = _torch(x, x_star)
    tmean, tvar = tmodel.posterior_from_cache(tx, cache, tx_star)
    _close(tmean, jmean, rtol)
    _close(tvar, jvar, rtol)


def test_love_variance_is_exact_at_full_rank():
    """With k = n Lanczos steps the inverse root spans everything, and the
    LOVE variance equals the exact posterior's (CG run to 1e-10)."""
    x, y, x_star = _torch(*_data("single", np.float64))
    _, _, tmodel = _models(False, np.float64)
    with _Both(**{**LOVE, "max_root_decomposition_size": 96, "cg_tolerance": 1e-10, "max_cg_iterations": 1000}):
        cache = tmodel.posterior_cache(x, y)
        mean, var = tmodel.posterior_from_cache(x, cache, x_star)
        want_mean, want_var = tmodel.posterior(x, y, x_star)
    with torch.no_grad():
        prior = float(tmodel.covariance(x_star).diagonal().max())
    np.testing.assert_allclose(_np(mean), _np(want_mean), rtol=0, atol=1e-6 * np.abs(_np(want_mean)).max())
    np.testing.assert_allclose(_np(var), _np(want_var), rtol=0, atol=1e-6 * prior)
