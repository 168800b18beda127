"""The port's exact-GP slice (neg_mll and posterior) against the JAX package,
stage by stage and whole.

Stages run in float64 on the blocked (plain) kernel path at rtol 1e-8: both
packages do the same arithmetic, so they differ only by summation order.  The
whole slice is checked in float64 on the blocked path at rtol 1e-7 and in
float32 on the fused path (JAX ``use_pallas=True``, the port's
``use_fused_kernels=True``, whose kernels run their plain versions here) at
rtol 1e-4.  Both sides get identical probe draws by patching each package's
``LowRankRootAddedDiagLinearOperator.zero_mean_mvn_samples`` to return the
same numpy array.  All inputs come from seeded numpy generators.
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
    """Both packages' preconditioner draws return one numpy array."""

    def install(dtype):
        state = {}

        def draws(num_samples, n):
            if "z" not in state:
                state["z"] = np.random.default_rng(8).normal(size=(num_samples, n)).astype(dtype)
            return state["z"]

        def jax_draw(self, num_samples, *, key=None):
            return jnp.asarray(draws(num_samples, self.shape[-1]))

        def torch_draw(self, num_samples, *, generator=None):
            return torch.from_numpy(draws(num_samples, self.shape[-1])).to(self.device)

        monkeypatch.setattr(JaxLowRank, "zero_mean_mvn_samples", jax_draw)
        monkeypatch.setattr(TorchLowRank, "zero_mean_mvn_samples", torch_draw)

    return install


def _models(fused, dtype):
    """A JAX model and a port model with the JAX parameters carried across."""
    jdtype = jnp.float32 if dtype == np.float32 else jnp.float64
    jmodel = JaxGP(use_pallas=fused, materialize_threshold=None)
    params = jmodel.init_params(3, dtype=jdtype)._replace(
        raw_lengthscale=jnp.asarray(-0.3, jdtype), raw_noise=jnp.asarray(-1.5, jdtype)
    )
    tmodel = tlo.ExactGPRegression(
        use_fused_kernels=fused, materialize_threshold=None, device="cpu",
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


def test_backward_raises_not_implemented():
    x, y, x_star = (torch.from_numpy(a.astype(np.float32)) for a in _gp_data(12, n=64, m=4))
    model = tlo.ExactGPRegression(device="cpu")
    with _Both(**SLICE):
        loss = model.neg_mll(x, y, generator=torch.Generator())
        with pytest.raises(NotImplementedError, match="next slice"):
            loss.backward()
        mean, _ = model.posterior(x, y, x_star)
        with pytest.raises(NotImplementedError, match="next slice"):
            mean.sum().backward()


def test_pivoted_mode_names_the_later_slice():
    x, y, _ = (torch.from_numpy(a.astype(np.float32)) for a in _gp_data(13, n=64))
    model = tlo.ExactGPRegression(device="cpu")
    with _Both(**{**SLICE, "preconditioner_mode": "pivoted"}):
        with pytest.raises(NotImplementedError, match="pivoted_cholesky.py"):
            model.neg_mll(x, y, generator=torch.Generator())
