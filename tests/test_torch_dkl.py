"""The port's deep kernel learning model (``models/dkl.py``) against the JAX
package.

Seeded numpy inputs go through the jitted JAX model and the port's model
with the JAX parameters carried across (``load_jax_params``; the JAX MLP's
(in, out) weights become ``nn.Linear``'s (out, in)).  The MLL runs CG and SLQ
in both packages, with ``same_draws`` giving both the same probes, Nystrom
test matrix and Lanczos start: the loss, its gradient for every parameter
(each MLP layer's weights and biases, the first layer's included, and the
GP head's), the posterior and the LOVE cache's predictions are held to 1e-7
in float64 on the blocked path (the fused kernels take float32), and in
float32 on the port's fused path (the kernels' plain versions here) to 1e-4.
The JAX package's own tests' properties are held on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu_torch as tlo
from linear_operator_tpu.models import DeepKernelGPRegression as JaxDKL
from linear_operator_tpu_torch.models import init_mlp, mlp_features
from test_torch_gp_slice import _Both, _close, _grad_close, _np
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_ski import same_draws  # noqa: F401 (a fixture)
from test_torch_structure import _jit

CG64 = 1e-7
F32 = 1e-4
HIDDEN = (16, 8, 2)
# CG and SLQ, never Cholesky: with no preconditioner, and with the "auto"
# Nystrom preconditioner switched on at this n.  CG runs to 1e-10: at a
# looser tolerance a column whose residual lands near it may stop one
# iteration apart in the two packages (summation order), ~1e-7 of the
# gradient unpreconditioned
CG = dict(max_cholesky_size=0, num_trace_samples=8, max_cg_iterations=200, cg_tolerance=1e-10,
          max_lanczos_quadrature_iterations=20, min_preconditioning_size=10**9)
NYSTROM = {**CG, "preconditioner_mode": "auto", "min_preconditioning_size": 0}


def _data(seed, n=100, d=5, m=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(3.0 * np.tanh(x @ np.linspace(-1.0, 1.0, d))) + 0.05 * rng.normal(size=n)
    return x, y, rng.normal(size=(m, d))


def _models(dtype=np.float64, fused=False, d=5):
    """The JAX model and its parameters, and the port's model with them
    carried across; the JAX package on its blocked path, the port on the
    blocked or the fused path."""
    jmodel = JaxDKL(hidden=HIDDEN, materialize_threshold=None, block_rows=64)
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
    params = jmodel.init_params(d, key=jax.random.PRNGKey(3), dtype=jdtype)
    params = params._replace(gp=params.gp._replace(raw_noise=jnp.asarray(-1.5, jdtype)))
    tmodel = tlo.DeepKernelGPRegression(
        d, HIDDEN, dtype=torch.float64 if dtype == np.float64 else torch.float32, device="cpu",
        use_fused_kernels=fused, materialize_threshold=None, block_rows=64,
    )
    tlo.load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _grads(tmodel):
    """The port's gradients in the JAX package's layout: per layer the
    weights (in, out) and the biases, then the GP head's."""
    layers = [m for m in tmodel.mlp if isinstance(m, torch.nn.Linear)]
    parts = [_np(layer.weight.grad).T for layer in layers] + [_np(layer.bias.grad) for layer in layers]
    parts += [_np(getattr(tmodel.gp, name).grad) for name in ("raw_lengthscale", "raw_outputscale", "raw_noise")]
    return np.concatenate([np.ravel(p) for p in parts])


def _jax_grads(g):
    return np.concatenate([np.ravel(np.asarray(leaf)) for leaf in (*g.mlp.weights, *g.mlp.biases, *g.gp)])


@pytest.mark.parametrize("settings", [CG, NYSTROM], ids=["cg", "nystrom"])
def test_neg_mll_and_gradients_match_jax(same_draws, settings):
    x, y, _ = _data(0)
    jmodel, params, tmodel = _models()
    with _Both(**settings):
        want, jg = _jit(jax.value_and_grad(
            lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y), key=jax.random.PRNGKey(0))))(params)
        loss = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y), generator=torch.Generator())
        loss.backward()
    _close(loss, want, CG64)
    got, expect = _grads(tmodel), _jax_grads(jg)
    _grad_close(got, expect, CG64)
    # the first layer's weights on their own, relative to their own norm
    first = slice(0, 5 * HIDDEN[0])
    _grad_close(got[first], expect[first], CG64)
    assert np.abs(got[first]).max() > 0.0


def test_posterior_and_the_love_cache_match_jax(same_draws):
    x, y, xs = _data(1)
    jmodel, params, tmodel = _models()
    jx, jy, jxs = (jnp.asarray(a) for a in (x, y, xs))
    tx, ty, txs = (torch.from_numpy(a) for a in (x, y, xs))
    with _Both(**NYSTROM, max_root_decomposition_size=30):
        jmean, jvar = _jit(lambda p: jmodel.posterior(p, jx, jy, jxs, key=jax.random.PRNGKey(0)))(params)
        cache_mean, cache_var = _jit(lambda p: jmodel.posterior_from_cache(
            p, jx, jmodel.posterior_cache(p, jx, jy, key=jax.random.PRNGKey(0)), jxs))(params)
        with torch.no_grad():
            mean, var = tmodel.posterior(tx, ty, txs, generator=torch.Generator())
            cache = tmodel.posterior_cache(tx, ty, generator=torch.Generator())
            tcache_mean, tcache_var = tmodel.posterior_from_cache(tx, cache, txs)
    for got, want in ((mean, jmean), (var, jvar), (tcache_mean, cache_mean), (tcache_var, cache_var)):
        _close(got, want, CG64)
    # the cache carried across from the JAX package gives the same predictions
    jcache = jmodel.posterior_cache(params, jx, jy, key=jax.random.PRNGKey(0))
    with torch.no_grad():
        carried = tmodel.posterior_from_cache(tx, tlo.load_jax_cache(tmodel.gp, jcache), txs)
    _close(carried[0], jmodel.posterior_from_cache(params, jx, jcache, jxs)[0], 1e-10)


def test_float32_fused_matches_jax(same_draws):
    """The port's fused path (the kernels' plain versions on the CPU) in
    float32 against the JAX package's blocked float32 path."""
    x, y, xs = (a.astype(np.float32) for a in _data(2))
    jmodel, params, tmodel = _models(np.float32, fused=True)
    assert tmodel.gp.use_fused_kernels
    with _Both(**CG):
        want, jg = _jit(jax.value_and_grad(
            lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y), key=jax.random.PRNGKey(0))))(params)
        loss = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y), generator=torch.Generator())
        loss.backward()
        jmean, jvar = _jit(lambda p: jmodel.posterior(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs)))(params)
        with torch.no_grad():
            mean, var = tmodel.posterior(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xs))
    _close(loss, want, F32)
    got, expect = _grads(tmodel), _jax_grads(jg)
    _grad_close(got, expect, F32)
    _grad_close(got[: 5 * HIDDEN[0]], expect[: 5 * HIDDEN[0]], F32)
    _close(mean, jmean, F32)
    _close(var, jvar, F32)


def test_fused_gradients_match_the_plain_path(same_draws):
    """On the same probes the fused path's gradients, the MLP's through K3's
    backward (K2), are the blocked path's."""
    x, y, _ = (torch.from_numpy(a.astype(np.float32)) for a in _data(3))
    grads = []
    for fused in (True, False):
        _, _, model = _models(np.float32, fused=fused)
        with _Both(**CG):
            model.neg_mll(x, y, generator=torch.Generator()).backward()
        grads.append(_grads(model))
    _grad_close(grads[0], grads[1], F32)


def test_cholesky_and_cg_gradients_agree():
    """The data-leaf gradients of the dense Cholesky path and of the CG/SLQ
    path agree (the SLQ gradient is Monte Carlo: 2048 probes)."""
    x, y, _ = (torch.from_numpy(a) for a in _data(4, n=64))
    grads = []
    for settings in (dict(max_cholesky_size=1000),
                     dict(max_cholesky_size=0, cg_tolerance=1e-10, max_cg_iterations=200, num_trace_samples=2048,
                          min_preconditioning_size=10**9)):
        _, _, model = _models()
        with _Both(**settings):
            model.neg_mll(x, y, generator=torch.Generator().manual_seed(0)).backward()
        grads.append(_grads(model))
    scale = np.abs(grads[0]).max()
    np.testing.assert_allclose(grads[1] / scale, grads[0] / scale, rtol=0, atol=0.25)


def test_training_improves_the_mll_and_the_fit():
    x, y, _ = (torch.from_numpy(a) for a in _data(5, n=120))
    _, _, model = _models()
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    losses = []
    for _ in range(40):
        opt.zero_grad()
        loss = model.neg_mll(x, y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] - 0.05, losses
    with torch.no_grad():
        mean, var = model.posterior(x, y, x)
    assert float(((mean - y) ** 2).mean()) < 0.05 and bool((var >= 0).all())


def test_every_parameter_gets_a_gradient_and_the_features_drive_the_kernel():
    x, y, _ = (torch.from_numpy(a) for a in _data(6, n=30, d=7))
    model = tlo.DeepKernelGPRegression(7, (8, 3), generator=torch.Generator().manual_seed(0),
                                       dtype=torch.float64, device="cpu")
    assert model.feature_dim == 3 and model.gp.use_fused_kernels
    assert tuple(model.features(x).shape) == (30, 3)
    K = model.train_operator(x)
    assert tuple(K.shape) == (30, 30)
    dense = K.to_dense().detach()
    np.testing.assert_allclose(_np(dense), _np(dense).T, atol=1e-12)
    model.neg_mll(x, y).backward()
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0.0, name


def test_init_mlp_is_he_scaled_tanh_layers():
    mlp = init_mlp((400, 300, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
    layers = [m for m in mlp if isinstance(m, torch.nn.Linear)]
    assert [tuple(m.weight.shape) for m in layers] == [(300, 400), (2, 300)]
    assert isinstance(mlp[1], torch.nn.Tanh) and len(mlp) == 3
    np.testing.assert_allclose(float(layers[0].weight.detach().std()), np.sqrt(2.0 / 400), rtol=0.02)
    assert all(float(m.bias.abs().max()) == 0.0 for m in layers)
    x = torch.randn(5, 400, dtype=torch.float64)
    want = layers[1](torch.tanh(layers[0](x)))
    np.testing.assert_allclose(_np(mlp_features(mlp, x)), _np(want), rtol=1e-14)
    # the same generator state, the same weights
    again = init_mlp((400, 300, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
    assert torch.equal(again[0].weight, layers[0].weight)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlo.DeepKernelGPRegression(5)
