"""The port's SGPR model (``models/sgpr.py``) against the JAX package.

Seeded numpy inputs go through the jitted JAX model and the port's model
with the JAX parameters carried across (``load_jax_params``).  The collapsed
ELBO, its gradient for every parameter (the inducing locations included)
and the posterior are closed forms in both packages: held to 1e-10 in
float64 (values relative to the largest entry, gradients to their norm),
and to 1e-4 in float32.  The inducing rows are held identical, and the
properties the JAX package's own tests assert are held on the port, with
``torch.optim.Adam`` in place of optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu_torch as tlo
from linear_operator_tpu.models import SGPRRegression as JaxSGPR
from linear_operator_tpu_torch.models.sgpr import inducing_rows
from linear_operator_tpu_torch.operators import LowRankRootAddedDiagLinearOperator
from test_torch_gp_slice import _close, _grad_close, _np
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_structure import _jit
from test_torch_woodbury import solver_log  # noqa: F401 (a fixture)

F64 = 1e-10
F32 = 1e-4
FIELDS = ("raw_lengthscale", "raw_outputscale", "raw_noise", "z")


def _data(seed, n=120, d=2, m=15):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(2.0 * x[:, 0]) + 0.05 * rng.normal(size=n)
    return x, y, rng.normal(size=(m, d))


def _models(x, m, dtype=np.float64):
    """The JAX model's initial parameters, moved off their start so that no
    gradient is special, and the port's model with them carried across."""
    jmodel = JaxSGPR()
    params = jmodel.init_params(jnp.asarray(x, dtype), m)
    params = params._replace(
        raw_lengthscale=jnp.asarray(-0.2, dtype), raw_outputscale=jnp.asarray(0.3, dtype),
        raw_noise=jnp.asarray(-1.7, dtype), z=params.z + 0.05,
    )
    tmodel = tlo.SGPRRegression(torch.from_numpy(x.astype(dtype)), m, device="cpu")
    tlo.load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _grads(tmodel):
    return np.concatenate([_np(getattr(tmodel, name).grad).ravel() for name in FIELDS])


def _jax_grads(g):
    return np.concatenate([np.ravel(getattr(g, name)) for name in FIELDS])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n, m", [(334, 3), (11, 5), (8, 3), (7, 7), (1000, 512), (100_000, 1024), (99_999, 999), (5, 1)])
def test_inducing_rows_match_jax(n, m, dtype):
    """The same rows in both packages, where linspace lands on .5 (334, 3:
    166.5; 11, 5: 2.5 and 7.5; 8, 3: 3.5), rounded half to even, and at the
    sizes of the chip run."""
    x = np.arange(n, dtype=dtype)[:, None]
    want = np.asarray(JaxSGPR().init_params(jnp.asarray(x), m).z)[:, 0]
    model = tlo.SGPRRegression(torch.from_numpy(x), m, device="cpu")
    np.testing.assert_array_equal(_np(model.z)[:, 0], want)
    np.testing.assert_array_equal(_np(inducing_rows(n, m)), want.astype(np.int64))
    assert model.z.dtype == torch.from_numpy(x).dtype
    if (n, m) == (334, 3):
        assert want[1] == 166.0  # 166.5, half to even


def test_elbo_and_gradients_match_jax():
    x, y, _ = _data(0)
    jmodel, params, tmodel = _models(x, 20)
    want, jg = _jit(jax.value_and_grad(lambda p: jmodel.neg_elbo(p, jnp.asarray(x), jnp.asarray(y))))(params)
    loss = tmodel.neg_elbo(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss, want, F64)
    _grad_close(_grads(tmodel), _jax_grads(jg), F64)
    _close(tmodel.elbo(torch.from_numpy(x), torch.from_numpy(y)),
           _jit(lambda p: jmodel.elbo(p, jnp.asarray(x), jnp.asarray(y)))(params), F64)


def test_posterior_and_its_gradients_match_jax():
    x, y, xs = _data(1)
    jmodel, params, tmodel = _models(x, 20)

    def jax_total(p):
        mean, var = jmodel.posterior(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs))
        return jnp.sum(mean) + jnp.sum(var), (mean, var)

    (_, (jmean, jvar)), jg = _jit(jax.value_and_grad(jax_total, has_aux=True))(params)
    mean, var = tmodel.posterior(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xs))
    (mean.sum() + var.sum()).backward()
    _close(mean, jmean, F64)
    _close(var, jvar, F64)
    _grad_close(_grads(tmodel), _jax_grads(jg), F64)


def test_float32_matches_jax():
    x, y, xs = (a.astype(np.float32) for a in _data(2))
    jmodel, params, tmodel = _models(x, 20, np.float32)
    want, jg = _jit(jax.value_and_grad(lambda p: jmodel.neg_elbo(p, jnp.asarray(x), jnp.asarray(y))))(params)
    loss = tmodel.neg_elbo(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss, want, F32)
    _grad_close(_grads(tmodel), _jax_grads(jg), F32)
    jmean, jvar = _jit(lambda p: jmodel.posterior(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs)))(params)
    with torch.no_grad():
        mean, var = tmodel.posterior(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xs))
    _close(mean, jmean, F32)
    _close(var, jvar, F32)


@pytest.mark.parametrize("max_cholesky_size", [800, 0])
def test_elbo_runs_the_woodbury_closed_forms(solver_log, max_cholesky_size):
    """The marginal term is a LowRankRootAddedDiag whose inv_quad_logdet is
    the exact Woodbury form, below and above max_cholesky_size: the only
    solver the ELBO and its backward run is L_mm's Cholesky (no linear_cg,
    no Lanczos)."""
    x, y, _ = _data(3)
    _, _, tmodel = _models(x, 20)
    assert isinstance(tmodel.train_operator(torch.from_numpy(x)), LowRankRootAddedDiagLinearOperator)
    with tlo.settings.max_cholesky_size(max_cholesky_size):
        tmodel.neg_elbo(torch.from_numpy(x), torch.from_numpy(y)).backward()
    # train_operator's L_mm above, then the ELBO's
    assert solver_log == ["psd_safe_cholesky"] * 2, solver_log


def test_elbo_lower_bounds_the_exact_mll():
    """ELBO <= exact log marginal likelihood, rising with m, tight at m = n."""
    x, y, _ = _data(4, n=100)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    exact = tlo.ExactGPRegression(device="cpu", dtype=torch.float64)
    with tlo.settings.max_cholesky_size(1000):
        exact_ll = float(-exact.neg_mll(xt, yt).detach() * 100)
    last = -np.inf
    for m in (10, 40, 100):
        with torch.no_grad():
            elbo = float(tlo.SGPRRegression(xt, m, device="cpu").elbo(xt, yt))
        assert elbo <= exact_ll + 1e-6 and elbo >= last - 1e-6
        last = elbo
    np.testing.assert_allclose(last, exact_ll, rtol=1e-5, atol=1e-4)


def test_posterior_at_m_equal_n_is_the_exact_gp():
    x, y, xs = _data(5, n=90)
    xt, yt, xst = (torch.from_numpy(a) for a in (x, y, xs))
    with torch.no_grad():
        mean, var = tlo.SGPRRegression(xt, 90, device="cpu").posterior(xt, yt, xst)
        with tlo.settings.max_cholesky_size(1000):
            mean_e, var_e = tlo.ExactGPRegression(device="cpu", dtype=torch.float64).posterior(xt, yt, xst)
    # K_mm's jitter: agreement to its level, not to machine precision
    np.testing.assert_allclose(_np(mean), _np(mean_e), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(var), _np(var_e), rtol=1e-3, atol=1e-4)


def test_training_improves_the_elbo():
    x, y, _ = _data(6, n=150)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    model = tlo.SGPRRegression(xt, 15, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=3e-2)
    losses = []
    for _ in range(30):
        opt.zero_grad()
        loss = model.neg_elbo(xt, yt)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_defaults_to_cuda():
    x = torch.zeros(10, 2)
    if torch.cuda.is_available():
        assert tlo.SGPRRegression(x, 4).z.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlo.SGPRRegression(x, 4)


def test_psd_safe_cholesky_gradient_skips_the_failed_attempts(monkeypatch):
    """psd_safe_cholesky's gradient is cholesky(A + jitter I)'s with the
    jitter it took, as the JAX package's custom VJP gives it.  A failed
    attempt's factor holds NaN on the card (emulated here: the CPU leaves
    finite entries); differentiating through the retries carried that NaN
    into the gradient of a jittered K_mm (SGPR at m = 512, SVGP at m = 1024,
    in f32 on the card)."""
    from linear_operator_tpu.utils.cholesky import psd_safe_cholesky as jax_psd_safe_cholesky
    from linear_operator_tpu_torch.utils.cholesky import psd_safe_cholesky, psd_safe_cholesky_ex

    real = torch.linalg.cholesky_ex

    class AsOnTheCard(torch.autograd.Function):
        """cholesky_ex whose failed elements hold NaN, differentiated by
        torch's own rule (Murray 2016) on that factor."""

        @staticmethod
        def forward(ctx, A):
            L, info = real(A)
            L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
            ctx.save_for_backward(L)
            ctx.mark_non_differentiable(info)
            return L, info

        @staticmethod
        def backward(ctx, gL, _):
            (L,) = ctx.saved_tensors
            gA = (L.mH @ gL).tril()
            gA = 0.5 * (gA + gA.tril(-1).mH)
            gA = torch.linalg.solve_triangular(L.mH, gA, upper=True, left=True)
            return torch.linalg.solve_triangular(L, gA, upper=False, left=False)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", lambda A: AsOnTheCard.apply(A))
    rng = np.random.default_rng(7)
    b = rng.normal(size=(2, 6, 4))
    # rank 4 of 6 less 1e-7 I: the first try fails, a jitter of 1e-6 factors it
    A = b @ np.swapaxes(b, -1, -2) - 1e-7 * np.eye(6)
    A[1] += np.eye(6)  # the second element factors at once
    w = rng.normal(size=(2, 6, 6))
    At = torch.tensor(A, requires_grad=True)
    L = psd_safe_cholesky(At, jitter=1e-6, max_tries=3)
    torch.sum(L * torch.from_numpy(w)).backward()
    jgrad = jax.grad(lambda a: jnp.sum(jax_psd_safe_cholesky(a, jitter=1e-6, max_tries=3) * w))(jnp.asarray(A))
    took = _np(psd_safe_cholesky_ex(torch.from_numpy(A), jitter=1e-6, max_tries=3).jitter)
    assert took[0] > 0 and took[1] == 0
    assert torch.isfinite(At.grad).all()
    _close(L, np.linalg.cholesky(A + took[:, None, None] * np.eye(6)), 1e-10)
    _grad_close(At.grad, np.asarray(jgrad), 1e-8)
