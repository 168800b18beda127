"""The kernel operator's covariances and layouts against the JAX package
(mirrors the non-harness classes of tests/operators/test_kernel.py:
TestPallasStationaryCovars, TestNewCovariances, TestSpectralMixture,
TestFusedBilinearDerivative and TestBatchedSymPallasMatvec).

The same numpy inputs go to both packages.  Where the JAX side takes its
Pallas kernels (``use_pallas=True``), they run in interpret mode, as the
JAX package's own tests run them on the CPU, against the port's fused
operator, whose CPU route is the kernels' plain versions: f32, within 1e-4
of the largest entry (the Pallas kernels contract as three bf16 products).
The blocked paths of the two packages agree in f64 within 1e-10.  The JAX
references are jitted with XLA's backend optimizations off (``_jit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linear_operator_tpu.operators import kernel as jk
from linear_operator_tpu.ops import rbf as jrbf
from linear_operator_tpu_torch.operators import kernel as tk
from linear_operator_tpu_torch.operators._linear_operator import LinearOperator as TLinearOperator
from linear_operator_tpu_torch.ops import rbf as trbf
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_structure import _jit

F32, F64 = 1e-4, 1e-10
# each stationary family: (the JAX constructor, the port's, their keywords)
FAMILIES = {
    "matern12": (jk.matern_kernel_operator, tk.matern_kernel_operator, dict(nu=0.5)),
    "matern32": (jk.matern_kernel_operator, tk.matern_kernel_operator, dict(nu=1.5)),
    "matern52": (jk.matern_kernel_operator, tk.matern_kernel_operator, dict(nu=2.5)),
    "rq": (jk.rq_kernel_operator, tk.rq_kernel_operator, dict(alpha=2.0)),
}


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs error {err:.3e} > {rtol:.0e} x {scale:.3e}"


def _ops(family, x1, x2, fused, dtype, ls=0.8, os_=1.3):
    """The two packages' operators of ``family`` on x1 (and x2), fused or
    blocked (the JAX package's Pallas kernels or its lax.map engine)."""
    jmake, tmake, kw = FAMILIES[family]
    jx2 = None if x2 is None else jnp.asarray(x2, dtype=dtype)
    tx2 = None if x2 is None else _t(x2, torch.float32 if dtype == jnp.float32 else torch.float64)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.float64
    j = jmake(jnp.asarray(x1, dtype=dtype), jx2, lengthscale=jnp.asarray(ls, dtype), outputscale=jnp.asarray(os_, dtype),
              use_pallas=fused, **kw)
    t = tmake(_t(x1, tdtype), tx2, lengthscale=ls, outputscale=os_, use_fused_kernels=fused, **kw)
    return j, t


# -- TestPallasStationaryCovars ---------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stationary_matvecs_match_jax(family):
    """Symmetric (K3 on the card), rectangular (K1) and batched mat-vecs of
    each covariance: the fused operator against the JAX Pallas path in f32,
    the blocked operator against the JAX blocked path in f64."""
    r = _rng(160)
    xs, x1, x2, xb1, xb2 = (r.normal(size=s) for s in ((40, 3), (30, 3), (17, 3), (2, 14, 3), (2, 9, 3)))
    rs, rr, rb = (r.normal(size=s) for s in ((40, 2), (17, 2), (2, 9, 2)))
    for fused, dtype, tol in ((True, jnp.float32, F32), (False, jnp.float64, F64)):
        cases = [(xs, None, rs), (x1, x2, rr), (xb1, xb2, rb)]
        ops = [_ops(family, a, b, fused, dtype) for a, b, _ in cases]
        want = _jit(lambda js, rhs: [j @ v for j, v in zip(js, rhs)])(
            [j for j, _ in ops], [jnp.asarray(v, dtype) for _, _, v in cases])
        tdtype = torch.float32 if fused else torch.float64
        for (j, t), (_, _, v), w in zip(ops, cases, want):
            assert (t.matvec_impl is not None) == fused
            _close(t @ _t(v, tdtype), w, tol, f"{family} fused={fused} {tuple(t.shape)}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stationary_gradients_match_jax(family):
    """d/dx and d/dlengthscale of sum((K @ rhs)^2): through K2 (the port's
    plain version here) against the JAX Pallas backward in f32, and on the
    blocked paths in f64."""
    r = _rng(165)
    x0, rhs = r.normal(size=(18, 2)), r.normal(size=(18, 1))
    jmake, tmake, kw = FAMILIES[family]
    for fused, jdt, tdt, tol in ((True, jnp.float32, torch.float32, F32), (False, jnp.float64, torch.float64, F64)):

        def f(x, ls):
            op = jmake(x, lengthscale=ls, outputscale=jnp.asarray(1.0, jdt), use_pallas=fused, **kw)
            return jnp.sum((op @ jnp.asarray(rhs, jdt)) ** 2)

        gx_j, gl_j = _jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x0, jdt), jnp.asarray(0.8, jdt))
        x, ls = _t(x0, tdt).requires_grad_(), torch.tensor(0.8, dtype=tdt, requires_grad=True)
        op = tmake(x, lengthscale=ls, outputscale=1.0, use_fused_kernels=fused, **kw)
        gx, gl = torch.autograd.grad(torch.sum((op @ _t(rhs, tdt)) ** 2), (x, ls))
        _close(gx, gx_j, tol, f"{family} fused={fused} dx")
        _close(gl, gl_j, tol, f"{family} fused={fused} dlengthscale")


def test_per_dimension_lengthscale_fused_matches_blocked():
    """Matern-5/2 with one lengthscale a dimension, GPyTorch's default fit:
    fused against blocked, values and every gradient, against the JAX
    package's blocked path in f64."""
    r = _rng(168)
    x0, rhs, ls0 = r.normal(size=(25, 3)), r.normal(size=(25, 2)), np.asarray([0.6, 0.7, 0.8])

    def f(x, ls, os_):
        op = jk.matern_kernel_operator(x, lengthscale=ls, outputscale=os_, nu=2.5)
        return jnp.sum((op @ jnp.asarray(rhs)) ** 2)

    want = _jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(jnp.asarray(x0), jnp.asarray(ls0), jnp.asarray(0.693))
    for fused, dtype, tol in ((False, torch.float64, F64), (True, torch.float32, F32)):
        leaves = [_t(x0, dtype).requires_grad_(), _t(ls0, dtype).requires_grad_(), torch.tensor(0.693, dtype=dtype,
                                                                                              requires_grad=True)]
        op = tk.matern_kernel_operator(leaves[0], lengthscale=leaves[1], outputscale=leaves[2], nu=2.5,
                                       use_fused_kernels=fused)
        val = torch.sum((op @ _t(rhs, dtype)) ** 2)
        grads = torch.autograd.grad(val, leaves)
        _close(val, want[0], tol, f"fused={fused} value")
        for g, w, name in zip(grads, want[1], ("dx", "dlengthscale", "doutputscale")):
            _close(g, w, tol, f"fused={fused} {name}")


def test_rbf_backward_unchanged():
    """K1's backward (K2 for dx1 and dx2, K1 for dv) against the JAX Pallas
    kernel's, f32."""
    r = _rng(166)
    x1, x2, v = (r.normal(size=s).astype(np.float32) for s in ((12, 2), (9, 2), (9, 1)))
    want = _jit(jax.grad(lambda a, b, c: jnp.sum(jrbf.kernel_matvec(a, b, c, 512, "rbf") ** 2), argnums=(0, 1, 2)))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v))
    leaves = [_t(a, torch.float32).requires_grad_() for a in (x1, x2, v)]
    got = torch.autograd.grad(torch.sum(trbf.kernel_matvec(*leaves, "rbf") ** 2), leaves)
    for g, w, name in zip(got, want, ("dx1", "dx2", "dv")):
        _close(g, w, F32, name)


def test_matern_rejects_other_nu():
    x = torch.zeros(4, 2, dtype=torch.float64)
    for nu in (1.0, 2.0, 3.5):
        with pytest.raises(ValueError, match="nu must be 0.5, 1.5 or 2.5"):
            tk.matern_kernel_operator(x, lengthscale=1.0, outputscale=1.0, nu=nu)


# -- TestNewCovariances -----------------------------------------------------


def test_matern12_and_rq_dense_goldens_match_jax():
    r = _rng(170)
    x = r.normal(size=(20, 3))
    j = jk.matern_kernel_operator(jnp.asarray(x), lengthscale=jnp.asarray(0.7), outputscale=jnp.asarray(1.4), nu=0.5)
    t = tk.matern_kernel_operator(_t(x), lengthscale=0.7, outputscale=1.4, nu=0.5)
    d = np.sqrt(np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1))
    _close(t.to_dense(), 1.4 * np.exp(-d / 0.7), F64, "matern12 golden")
    _close(t.to_dense(), _jit(lambda o: o.to_dense())(j), F64, "matern12 vs jax")
    x = r.normal(size=(18, 2))
    j = jk.rq_kernel_operator(jnp.asarray(x), lengthscale=jnp.asarray(0.9), outputscale=jnp.asarray(1.2),
                              alpha=jnp.asarray(1.7))
    t = tk.rq_kernel_operator(_t(x), lengthscale=0.9, outputscale=1.2, alpha=1.7, use_fused_kernels=False)
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1) / 0.81
    _close(t.to_dense(), 1.2 * (1.0 + d2 / 3.4) ** (-1.7), F64, "rq golden")
    _close(t.to_dense(), _jit(lambda o: o.to_dense())(j), F64, "rq vs jax")


def test_rq_alpha_gradient_blocked_but_not_fused():
    """alpha is differentiable on the blocked path (held against the JAX
    package in f64) and bound at construction on the fused one, which
    carries no alpha gradient in either package (the JAX package's fused
    path takes alpha as a Python float: a traced alpha does not construct)."""
    r = _rng(171)
    x, rhs = r.normal(size=(18, 2)), r.normal(size=(18, 1))

    def f(a, fused, dtype):
        o = jk.rq_kernel_operator(jnp.asarray(x, dtype), lengthscale=jnp.asarray(0.9, dtype),
                                  outputscale=jnp.asarray(1.2, dtype), alpha=a, use_pallas=fused)
        return jnp.sum((o @ jnp.asarray(rhs, dtype)) ** 2)

    ga_blocked = _jit(jax.grad(lambda a: f(a, False, jnp.float64)))(jnp.asarray(1.7))
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.grad(lambda a: f(a, True, jnp.float32))(jnp.asarray(1.7, jnp.float32))
    for fused, dtype in ((False, torch.float64), (True, torch.float32)):
        alpha = torch.tensor(1.7, dtype=dtype, requires_grad=True)
        xt = _t(x, dtype).requires_grad_()
        o = tk.rq_kernel_operator(xt, lengthscale=0.9, outputscale=1.2, alpha=alpha, use_fused_kernels=fused)
        _, ga = torch.autograd.grad(torch.sum((o @ _t(rhs, dtype)) ** 2), (xt, alpha), allow_unused=True)
        if fused:
            assert ga is None or float(ga) == 0.0
        else:
            assert abs(float(ga)) > 1e-3
            _close(ga, ga_blocked, F64, "d/dalpha")


def test_periodic_matches_jax():
    """Scalar and per-dimension parameters, values, exact periodicity and
    the period's gradient, against the JAX package in f64."""
    r = _rng(173)
    x = r.normal(size=(16, 2))
    kw = dict(lengthscale=0.8, outputscale=1.3, period=2.0)
    t = tk.periodic_kernel_operator(_t(x), **kw)
    diff = x[:, None, :] - x[None, :, :]
    golden = 1.3 * np.exp(-2.0 * np.sum(np.sin(np.pi * diff / 2.0) ** 2, axis=-1) / 0.64)
    _close(t.to_dense(), golden, F64, "golden")
    shifted = x.copy()
    shifted[:, 0] += 2.0
    _close(tk.periodic_kernel_operator(_t(shifted), _t(x), **kw).to_dense(), golden, 1e-12, "shifted by the period")
    x, rhs = r.normal(size=(14, 3)), r.normal(size=(14, 1))
    ls, pd = np.asarray([0.7, 0.9, 1.1]), np.asarray([1.5, 2.0, 2.5])

    def f(p):
        o = jk.periodic_kernel_operator(jnp.asarray(x), lengthscale=jnp.asarray(ls), outputscale=jnp.asarray(1.0),
                                        period=p)
        return jnp.sum((o @ jnp.asarray(rhs)) ** 2), o.to_dense()

    (val_j, dense_j), gp_j = _jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(pd))
    p = _t(pd).requires_grad_()
    o = tk.periodic_kernel_operator(_t(x), lengthscale=_t(ls), outputscale=1.0, period=p)
    assert o.matvec_impl is None
    val = torch.sum((o @ _t(rhs)) ** 2)
    (gp,) = torch.autograd.grad(val, (p,))
    _close(o.to_dense(), dense_j, F64, "per-dimension dense")
    _close(val, val_j, F64, "value")
    _close(gp, gp_j, F64, "d/dperiod")


def test_registered_covariance_matches_jax():
    """A covariance registered at run time is a ``covar=`` key of every
    wrapper: values and gradients against the JAX package's registered
    covariance in its Pallas kernels (f32), and K2 and K3 on it against the
    plain arithmetic."""
    name = trbf.register_tile_covar("test_cauchy_port", lambda d2: 1.0 / (1.0 + d2), lambda d2: -1.0 / (1.0 + d2) ** 2)
    assert name == "test_cauchy_port" and trbf.TILE_COVARS[name].covar_id is None
    jname = jrbf.register_tile_covar("test_cauchy_port", lambda d2: 1.0 / (1.0 + d2),
                                     lambda d2: -1.0 / (1.0 + d2) ** 2)
    r = _rng(175)
    x1, x2, v = (r.normal(size=s).astype(np.float32) for s in ((12, 2), (9, 2), (9, 1)))

    def ref(a, b, c):
        return jnp.sum(jrbf.kernel_matvec(a, b, c, 512, jname) ** 2)

    out_j = _jit(lambda a, b, c: jrbf.kernel_matvec(a, b, c, 512, jname))(*map(jnp.asarray, (x1, x2, v)))
    g_j = _jit(jax.grad(ref, argnums=(0, 1, 2)))(*map(jnp.asarray, (x1, x2, v)))
    leaves = [_t(a, torch.float32).requires_grad_() for a in (x1, x2, v)]
    out = trbf.kernel_matvec(*leaves, name)
    _close(out, out_j, F32, "K1 values")
    d2 = np.sum((x1[:, None, :] - x2[None, :, :]) ** 2, axis=-1)
    _close(out, (1.0 / (1.0 + d2)) @ v, 1e-6, "K1 against the dense covariance")
    for g, w, what in zip(torch.autograd.grad(torch.sum(out**2), leaves), g_j, ("dx1", "dx2", "dv")):
        _close(g, w, F32, what)
    xs = _t(x1, torch.float32)
    w = _t(r.normal(size=(12, 3)), torch.float32)
    _close(trbf.kernel_matvec_sym(xs, w, name), trbf.kernel_matvec_plain(xs, xs, w, name), 1e-7, "K3")
    k = 1.0 / (1.0 + torch.cdist(xs.double(), xs.double()) ** 2)
    _close(tk.KernelLinearOperator(xs, xs, {}, covar_func=lambda a, b: 1.0 / (1.0 + trbf.sq_dist(a, b)),
                                   symmetric=True).to_dense(), k, 1e-6, "the covariance as an operator")



def test_registered_covariance_on_the_card_takes_its_cuda_bodies_or_raises(monkeypatch):
    """On CUDA tensors a registered covariance launches the kernels with its
    own id and compiled header when it was given CUDA bodies, and raises
    before any launch when it was not: no wrapper runs a plain version on
    the card.  (The launches are stood in for by their plain versions here,
    with the card's device check patched; tests/test_torch_cuda.py runs them
    on the card.)"""
    bare = trbf.register_tile_covar("test_cauchy_bare", lambda d2: 1.0 / (1.0 + d2), lambda d2: -1.0 / (1.0 + d2) ** 2)
    compiled = trbf.register_tile_covar("test_cauchy_cuda", lambda d2: 1.0 / (1.0 + d2),
                                        lambda d2: -1.0 / (1.0 + d2) ** 2, cuda_covar="1.0f / (1.0f + d2)",
                                        cuda_dcovar="-1.0f / ((1.0f + d2) * (1.0f + d2))")
    spec = trbf.TILE_COVARS[compiled]
    assert spec.covar_id == 5 and "return (1.0f / (1.0f + d2));" in spec.header
    assert trbf.TILE_COVARS[bare].covar_id is None and trbf.TILE_COVARS[bare].header == ""
    with pytest.raises(ValueError, match="both"):
        trbf.register_tile_covar("test_cauchy_half", abs, abs, cuda_covar="d2")
    seen = []

    def launch(plain):
        def run(*args):
            seen.append(args[-1])
            return plain(*args[:-1])
        return run

    monkeypatch.setattr(trbf, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(trbf, "_launch_matvec", launch(lambda a, b, w: trbf.kernel_matvec_plain(a, b, w, compiled)))
    monkeypatch.setattr(trbf, "_launch_matvec_sym", launch(lambda a, w: trbf.kernel_matvec_plain(a, a, w, compiled)))
    monkeypatch.setattr(trbf, "_launch_weighted",
                        launch(lambda a, b, g, w: trbf.kernel_weighted_plain(a, b, g, w, compiled)))
    r = _rng(176)
    x1, x2, v, g = (_t(r.normal(size=s), torch.float32) for s in ((12, 2), (9, 2), (9, 3), (12, 3)))
    for call in (lambda c: trbf.kernel_matvec(x1, x2, v, c), lambda c: trbf.kernel_matvec_sym(x1, g, c),
                 lambda c: trbf.kernel_weighted(x1, x2, g, v, c), lambda c: trbf.rbf_build_sym_tiles(x1, 128, c)):
        with pytest.raises(ValueError, match="without CUDA bodies"):
            call(bare)
    assert seen == []
    _close(trbf.kernel_matvec(x1, x2, v, compiled), trbf.kernel_matvec_plain(x1, x2, v, bare), 1e-6, "K1")
    trbf.kernel_matvec_sym(x1, g, compiled)
    trbf.kernel_weighted(x1, x2, g, v, compiled)
    assert seen == [spec, spec, spec]


# -- TestSpectralMixture ----------------------------------------------------


def test_spectral_mixture_matches_jax():
    """The dense covariance, its reduction to an RBF (Q = 1, mu = 0), and a
    jittered solve, against the JAX package in f64."""
    r = _rng(180)
    x = r.normal(size=(15, 2))
    w, mu, s = np.asarray([0.6, 1.1, 0.3]), 0.5 * r.uniform(size=(3, 2)), 0.4 * r.uniform(size=(3, 2)) + 0.1
    t = tk.spectral_mixture_kernel_operator(_t(x), weights=w, means=mu, scales=s)
    j = jk.spectral_mixture_kernel_operator(jnp.asarray(x), weights=jnp.asarray(w), means=jnp.asarray(mu),
                                            scales=jnp.asarray(s))
    _close(t.to_dense(), _jit(lambda o: o.to_dense())(j), F64, "dense")
    tau = x[:, None, :] - x[None, :, :]
    golden = np.sum(w * np.prod(np.exp(-2.0 * np.pi**2 * tau[..., None, :] ** 2 * s**2)
                                * np.cos(2.0 * np.pi * mu * tau[..., None, :]), axis=-1), axis=-1)
    _close(t.to_dense(), golden, F64, "golden")
    x = r.normal(size=(12, 3))
    sm = tk.spectral_mixture_kernel_operator(_t(x), weights=[1.7], means=np.zeros((1, 3)), scales=np.full((1, 3), 0.3))
    rbf = tk.rbf_kernel_operator(_t(x), lengthscale=1.0 / (2.0 * np.pi * 0.3), outputscale=1.7)
    _close(sm.to_dense(), rbf.to_dense(), F64, "reduces to the RBF")
    x = np.linspace(0.0, 6.0, 40)[:, None]
    kw = dict(weights=np.asarray([1.0, 0.5]), means=np.asarray([[0.3], [1.2]]), scales=np.asarray([[0.2], [0.4]]))
    rhs = r.normal(size=(40, 1))
    t = tk.spectral_mixture_kernel_operator(_t(x), **kw)
    j = jk.spectral_mixture_kernel_operator(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()})
    assert float(torch.linalg.eigvalsh(t.to_dense()).min()) > -1e-10
    sol_j = _jit(lambda o, b: o.add_jitter(1e-4).solve(b))(j, jnp.asarray(rhs))
    _close(t.add_jitter(1e-4).solve(_t(rhs)), sol_j, 1e-8, "jittered solve")


def test_spectral_mixture_gradients_match_jax():
    r = _rng(184)
    x, rhs = r.normal(size=(10, 2)), r.normal(size=(10, 1))
    w, mu, s = np.asarray([0.8, 0.4]), np.asarray([[0.2, 0.5], [0.9, 0.1]]), np.asarray([[0.3, 0.2], [0.15, 0.25]])

    def f(w_, mu_, s_):
        o = jk.spectral_mixture_kernel_operator(jnp.asarray(x), weights=w_, means=mu_, scales=s_)
        return jnp.sum((o @ jnp.asarray(rhs)) ** 2)

    want = _jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (w, mu, s)))
    leaves = [_t(a).requires_grad_() for a in (w, mu, s)]
    o = tk.spectral_mixture_kernel_operator(_t(x), weights=leaves[0], means=leaves[1], scales=leaves[2])
    for g, wj, what in zip(torch.autograd.grad(torch.sum((o @ _t(rhs)) ** 2), leaves), want, ("w", "mu", "s")):
        _close(g, wj, F64, what)


# -- TestFusedBilinearDerivative --------------------------------------------


def _lmc_covar(x1, x2, lengthscale, lmc, jitter):
    """A dense LMC covariance, two rows a point: k(x1, x2) (x) (C C^T + jitter I)."""
    k = torch.exp(-0.5 * trbf.sq_dist(x1 / lengthscale, x2 / lengthscale))
    b = lmc @ lmc.mT + jitter * torch.eye(lmc.shape[-1], dtype=lmc.dtype)
    t = b.shape[-1]
    out = k[..., :, None, :, None] * b[:, None, :]
    return out.reshape(*out.shape[:-4], k.shape[-2] * t, k.shape[-1] * t)


def _lmc_covar_jax(x1, x2, lengthscale, lmc, jitter):
    k = jk.rbf_covar(x1, x2, lengthscale, jnp.asarray(1.0, x1.dtype))
    b = lmc @ lmc.T + jitter * jnp.eye(lmc.shape[-1], dtype=lmc.dtype)
    t = b.shape[-1]
    out = k[..., :, None, :, None] * b[:, None, :]
    return out.reshape(*out.shape[:-4], k.shape[-2] * t, k.shape[-1] * t)


def _bilinear_cases():
    r = _rng(190)

    def rbf(n, batch=()):
        x = r.normal(size=(*batch, n, 3))
        return (lambda a: tk.rbf_kernel_operator(_t(a), lengthscale=1.3, outputscale=0.7, block_rows=32,
                                                 use_fused_kernels=False),
                lambda a: jk.rbf_kernel_operator(jnp.asarray(a), lengthscale=1.3, outputscale=0.7, block_rows=32),
                x, 1)

    def matern():
        x = r.normal(size=(70, 2))
        return (lambda a: tk.matern_kernel_operator(_t(a), lengthscale=0.9, outputscale=1.2, nu=1.5, block_rows=32,
                                                    use_fused_kernels=False),
                lambda a: jk.matern_kernel_operator(jnp.asarray(a), lengthscale=0.9, outputscale=1.2, nu=1.5,
                                                    block_rows=32),
                x, 1)

    def added_diag():
        t, j, x, _ = rbf(100)
        return (lambda a: t(a).add_diagonal(torch.tensor(0.5, dtype=torch.float64)),
                lambda a: j(a).add_diagonal(jnp.asarray(0.5)), x, 1)

    def multi_output():
        # n > block_rows, two rows a point, and a static (non-tensor) param
        x, coeffs = r.normal(size=(70, 2)), r.normal(size=(2, 2))
        fields = dict(block_rows=32, symmetric=True, num_outputs_per_input=(2, 2), static_params=(("jitter", 0.1),))
        return (lambda a: tk.KernelLinearOperator(_t(a), _t(a), {"lengthscale": _t(0.9), "lmc": _t(coeffs)},
                                                  covar_func=_lmc_covar, **fields),
                lambda a: jk.KernelLinearOperator(jnp.asarray(a), jnp.asarray(a),
                                                  {"lengthscale": jnp.asarray(0.9), "lmc": jnp.asarray(coeffs)},
                                                  covar_func=_lmc_covar_jax, **fields),
                x, 2)

    return {"rbf": rbf(100), "matern": matern(), "added_diag": added_diag(), "batched": rbf(80, (2,)),
            "multi_output": multi_output()}


BILINEAR = _bilinear_cases()


@pytest.mark.parametrize("case", list(BILINEAR))
def test_blocked_bilinear_derivative_matches_default_and_jax(case):
    """The one-sweep blocked backward against autograd through the blocked
    mat-mul (the base class's) and against the JAX package's one-sweep
    backward, in f64, with n above ``block_rows``."""
    make, make_jax, x, t1 = BILINEAR[case]
    r = _rng(191)
    op = make(x)
    cols = 3
    left = r.normal(size=(*x.shape[:-2], x.shape[-2] * t1, cols))
    right = r.normal(size=(*x.shape[:-2], x.shape[-2] * t1, cols))
    op = op._with_leaves([t.detach().requires_grad_(t.is_floating_point()) for t in op._leaves()])
    got = op._bilinear_derivative(_t(left), _t(right))
    base = TLinearOperator._bilinear_derivative(op, _t(left), _t(right))
    want = jax.tree_util.tree_leaves(
        _jit(lambda o, a, b: o._bilinear_derivative(a, b))(make_jax(x), jnp.asarray(left), jnp.asarray(right)))
    got = [g for g in got if g is not None]
    base = [g for g in base if g is not None]
    assert len(got) == len(base) == len(want)
    for g, b, w in zip(got, base, want):
        _close(g, b, F64, f"{case}: one sweep vs autograd")
        _close(g, w, F64, f"{case}: vs JAX")


def test_int_param_leaf_passes_through_the_blocked_backward():
    """An index tensor among the params (a covariance on chosen dimensions)
    gets no gradient; the others match the base path's."""
    r = _rng(192)
    x, left, right = r.normal(size=(80, 3)), r.normal(size=(80, 4)), r.normal(size=(80, 4))

    def covar(x1, x2, lengthscale, dims):
        return tk.rbf_covar(x1[..., dims], x2[..., dims], lengthscale, torch.tensor(1.0, dtype=x1.dtype))

    xt = _t(x).requires_grad_()
    op = tk.KernelLinearOperator(xt, xt, {"lengthscale": _t(1.1).requires_grad_(), "dims": torch.tensor([0, 2])},
                                 covar_func=covar, block_rows=32, symmetric=True)
    got = op._bilinear_derivative(_t(left), _t(right))
    base = TLinearOperator._bilinear_derivative(op, _t(left), _t(right))
    assert got[3] is None and base[3] is None
    for g, b in zip(got[:3], base[:3]):
        _close(g, b, F64)


# -- TestBatchedSymPallasMatvec ---------------------------------------------


def test_batched_symmetric_fused_matvec_matches_jax():
    """A batch of symmetric RBF operators takes K3 (here its plain version)
    as the JAX package takes its symmetric Pallas kernel; f32."""
    r = _rng(193)
    x, v = r.normal(size=(3, 64, 3)).astype(np.float32), r.normal(size=(3, 64, 5)).astype(np.float32)
    params = {"lengthscale": 1.2, "outputscale": 0.8}
    want = _jit(lambda a, b: jk.rbf_pallas_matvec(a, a, b, {k: jnp.float32(p) for k, p in params.items()},
                                                  symmetric=True))(jnp.asarray(x), jnp.asarray(v))
    tparams = {k: torch.tensor(p) for k, p in params.items()}
    _close(tk.rbf_fused_matvec(_t(x, torch.float32), _t(x, torch.float32), _t(v, torch.float32), tparams,
                               symmetric=True), want, 2e-5)
    assert trbf.sym_matvec_supported(5) and not trbf.sym_matvec_supported(17)
