"""The port's multitask GP (``models/multitask.py``) against the JAX package.

Seeded numpy inputs go through the jitted JAX model and the port's model
with the JAX parameters carried across (``load_jax_params``).  The train
operator is a Kronecker product plus a constant diagonal in both packages,
so the negative MLL, its gradient for every parameter, the posterior mean
and the LOVE posterior run through the Kronecker closed forms (the factors'
eigendecompositions): held to 1e-10 in float64 (values relative to the
largest entry, gradients to their norm), and to 1e-4 in float32.  The JAX
package's own tests' properties (dense agreement, training) are held on the
port, with ``torch.optim.Adam`` in place of optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.models import MultitaskGPRegression as JaxMultitask
from linear_operator_tpu_torch.operators import KroneckerProductAddedDiagLinearOperator
from test_torch_gp_slice import _close, _grad_close, _np
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_structure import _jit
from test_torch_woodbury import solver_log  # noqa: F401 (a fixture)

F64 = 1e-10
F32 = 1e-4
FIELDS = ("raw_lengthscale", "raw_outputscale", "task_root", "raw_task_diag", "raw_noise")


def _data(seed, n=30, T=3, d=2, m=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.stack([np.sin(2 * x[:, 0] + i) for i in range(T)], axis=-1) + 0.05 * rng.normal(size=(n, T))
    return x, y, rng.normal(size=(m, d))


def _models(T=3, rank=2, dtype=np.float64, seed=0):
    """The JAX model's parameters, moved off their start, and the port's
    model with them carried across."""
    jmodel = JaxMultitask(num_tasks=T, task_rank=rank)
    rng = np.random.default_rng(seed)
    params = jmodel.init_params(2, dtype=dtype)._replace(
        raw_lengthscale=jnp.asarray(-0.2, dtype), raw_outputscale=jnp.asarray(0.3, dtype),
        task_root=jnp.asarray(np.eye(T, rank) + 0.3 * rng.normal(size=(T, rank)), dtype),
        raw_task_diag=jnp.asarray(0.2 * rng.normal(size=T), dtype), raw_noise=jnp.asarray(-1.7, dtype),
    )
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tmodel = tlo.MultitaskGPRegression(T, rank, dtype=tdtype, device="cpu")
    tlo.load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _grads(tmodel):
    return np.concatenate([_np(getattr(tmodel, name).grad).ravel() for name in FIELDS])


def _jax_grads(g):
    return np.concatenate([np.ravel(getattr(g, name)) for name in FIELDS])


def _dense(tmodel, x, xs=None):
    """K = K_xx (x) K_tt + s2 I and, with xs, the cross and prior blocks, in
    float64 numpy."""
    with torch.no_grad():
        ktt = _np(tmodel.task_covar())
        K = np.kron(_np(tmodel.data_covar(x)), ktt) + float(tlo.models.gp._softplus(tmodel.raw_noise)) * np.eye(
            x.shape[0] * ktt.shape[0])
        if xs is None:
            return K
        return K, np.kron(_np(tmodel.data_covar(xs, x)), ktt), np.kron(_np(tmodel.data_covar(xs)), ktt)


@pytest.mark.parametrize("max_cholesky_size", [800, 0])
def test_neg_mll_and_gradients_match_jax(max_cholesky_size):
    x, y, _ = _data(0)
    jmodel, params, tmodel = _models()
    with jlo.settings.max_cholesky_size(max_cholesky_size), tlo.settings.max_cholesky_size(max_cholesky_size):
        want, jg = _jit(jax.value_and_grad(lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y))))(params)
        loss = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
    _close(loss, want, F64)
    _grad_close(_grads(tmodel), _jax_grads(jg), F64)
    # and the dense value
    K, yv = _dense(tmodel, torch.from_numpy(x)), y.reshape(-1)
    dense = 0.5 * (yv @ np.linalg.solve(K, yv) + np.linalg.slogdet(K)[1] + yv.size * np.log(2 * np.pi)) / yv.size
    np.testing.assert_allclose(float(loss.detach()), dense, rtol=1e-10)


def test_train_operator_runs_the_kronecker_closed_forms(solver_log):
    """K_xx (x) K_tt + s2 I is a KroneckerProductAddedDiagLinearOperator; its
    MLL and backward run no solver: no CG, no Lanczos, no Cholesky."""
    x, y, _ = _data(1)
    _, _, tmodel = _models()
    assert isinstance(tmodel.train_operator(torch.from_numpy(x)), KroneckerProductAddedDiagLinearOperator)
    with tlo.settings.max_cholesky_size(0):
        tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y)).backward()
    assert solver_log == [], solver_log


def test_posteriors_and_their_gradients_match_jax():
    x, y, xs = _data(2)
    jmodel, params, tmodel = _models(seed=2)
    jx, jy, jxs = (jnp.asarray(a) for a in (x, y, xs))

    def jax_total(p):
        mean_only = jmodel.posterior_mean(p, jx, jy, jxs)
        mean, var = jmodel.posterior(p, jx, jy, jxs, key=jax.random.PRNGKey(0))
        return jnp.sum(mean_only) + jnp.sum(mean) + jnp.sum(var), (mean_only, mean, var)

    (_, (jmean_only, jmean, jvar)), jg = _jit(jax.value_and_grad(jax_total, has_aux=True))(params)
    tx, ty, txs = (torch.from_numpy(a) for a in (x, y, xs))
    mean_only = tmodel.posterior_mean(tx, ty, txs)
    mean, var = tmodel.posterior(tx, ty, txs, generator=torch.Generator().manual_seed(0))
    (mean_only.sum() + mean.sum() + var.sum()).backward()
    for got, want in ((mean_only, jmean_only), (mean, jmean), (var, jvar)):
        assert tuple(got.shape) == (xs.shape[0], y.shape[1])
        _close(got, want, F64)
    _grad_close(_grads(tmodel), _jax_grads(jg), F64)
    # and the dense posterior: the Kronecker root is exact, so is the variance
    K, ks, kss = _dense(tmodel, tx, txs)
    mean_d = (ks @ np.linalg.solve(K, y.reshape(-1))).reshape(mean.shape)
    var_d = (np.diag(kss) - np.sum(ks * np.linalg.solve(K, ks.T).T, axis=-1)).reshape(var.shape)
    np.testing.assert_allclose(_np(mean), mean_d, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(_np(var), var_d, rtol=1e-6, atol=1e-8)


def test_float32_matches_jax():
    x, y, xs = (a.astype(np.float32) for a in _data(3))
    jmodel, params, tmodel = _models(dtype=np.float32, seed=3)
    want, jg = _jit(jax.value_and_grad(lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y))))(params)
    loss = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss, want, F32)
    _grad_close(_grads(tmodel), _jax_grads(jg), F32)
    jmean, jvar = _jit(lambda p: jmodel.posterior(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs)))(params)
    with torch.no_grad():
        mean, var = tmodel.posterior(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xs))
    _close(mean, jmean, F32)
    _close(var, jvar, F32)


def test_training_reduces_the_loss():
    x, y, _ = (torch.from_numpy(a.astype(np.float32)) for a in _data(4))
    model = tlo.MultitaskGPRegression(3, 2, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    losses = []
    for _ in range(20):
        opt.zero_grad()
        loss = model.neg_mll(x, y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tlo.MultitaskGPRegression(3).task_root.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlo.MultitaskGPRegression(3)


def test_float32_gradient_at_n_1000_is_wrong_in_both_packages():
    """Shared with the JAX package: at n = 1000 the f32 loss agrees with f64,
    but the gradient runs through the f32 eigenvectors of the numerically
    low-rank K_xx, whose eigenvector derivative meets gaps of f32 rounding:
    in both packages the f32 lengthscale and outputscale gradient lies more
    than 5% of its norm from f64 (config 4's fault, ROADMAP.md queue 3)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 3))
    y = np.stack([np.sin(3 * x[:, 0] + i) for i in range(4)], -1) + 0.1 * rng.normal(size=(1000, 4))
    out = {}
    for dtype, tdtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
        jmodel = JaxMultitask(4, 2)
        jv, jg = _jit(jax.value_and_grad(lambda p: jmodel.neg_mll(p, jnp.asarray(x, dtype), jnp.asarray(y, dtype))))(
            jmodel.init_params(3, dtype=dtype))
        tmodel = tlo.MultitaskGPRegression(4, 2, dtype=tdtype, device="cpu")
        loss = tmodel.neg_mll(torch.tensor(x, dtype=tdtype), torch.tensor(y, dtype=tdtype))
        loss.backward()
        out[dtype] = (float(jv), float(loss.detach()), np.array([float(jg.raw_lengthscale), float(jg.raw_outputscale)]),
                      np.array([float(tmodel.raw_lengthscale.grad), float(tmodel.raw_outputscale.grad)]))
    j32, t32, jg32, tg32 = out[np.float32]
    j64, t64, jg64, tg64 = out[np.float64]
    np.testing.assert_allclose([j32, t32], [j64, j64], rtol=1e-4)
    # in f64 the same derivative leaves the packages ~4e-8 apart at this n
    assert np.linalg.norm(tg64 - jg64) <= 1e-6 * np.linalg.norm(jg64)
    for got in (jg32, tg32):
        assert np.linalg.norm(got - jg64) > 0.05 * np.linalg.norm(jg64), (got, jg64)
