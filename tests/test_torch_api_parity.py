"""The port's public surface against the reference's inventories, as
tests/test_api_parity.py holds the JAX package to them: every name the
reference exports from ``linear_operator``, ``.operators`` and ``.utils``
resolves in the port too (with that test's two exceptions), and the torch-
style conveniences, the ``StochasticLQ`` shim and the deprecated spellings
behave as the JAX package's do, on the same numpy inputs."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from test_api_parity import _EXCEPTIONS, REF_OPERATORS, REF_TOP, REF_UTILS
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_structure import _jit


def _spd(seed, n, shift):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return a @ a.T / n + shift * np.eye(n)


@pytest.mark.parametrize(
    "module, names",
    [(tlo, REF_TOP), (tlo.operators, REF_OPERATORS), (tlo.utils, REF_UTILS)],
    ids=["top", "operators", "utils"],
)
def test_surface_matches_the_inventories(module, names):
    missing = [n for n in names if n not in _EXCEPTIONS and not hasattr(module, n)]
    assert missing == []


def test_the_exceptions_have_their_replacements():
    assert hasattr(tlo.solvers, "lanczos_tridiag")
    assert hasattr(tlo.LinearOperator, "with_factorization")
    assert tlo.KeOpsLinearOperator is tlo.KernelLinearOperator
    assert tlo.__version__ == jlo.__version__


def test_stochastic_lq_shim_matches_jax():
    """The object-style SLQ workflow: the same probes through both packages'
    shims give the same Lanczos tridiagonals and logdet estimate (f64), and
    the estimate lies within 10% of the exact logdet, as in the JAX test."""
    n, p = 120, 48
    a = _spd(0, n, 0.5)
    probes = np.random.default_rng(1).normal(size=(n, p))
    probes /= np.linalg.norm(probes, axis=0, keepdims=True)
    slq = tlo.utils.StochasticLQ(max_iter=30, num_random_probes=p)
    mat = tlo.to_linear_operator(torch.tensor(a))
    q, t = slq.lanczos_batch(mat.matmul, torch.tensor(probes))
    assert q.shape == (p, n, 30) and t.shape == (p, 30, 30)
    evals, evecs = tlo.solvers.lanczos_tridiag_to_diag(t)
    (est,) = slq.to_dense((n, n), evals, evecs, [torch.log])

    def reference(mat, probes):
        jslq = jlo.utils.StochasticLQ(max_iter=30, num_random_probes=p)
        _, jt = jslq.lanczos_batch(mat.matmul, probes)
        jev, jevec = jlo.solvers.lanczos_tridiag_to_diag(jt)
        return jt, jslq.to_dense((n, n), jev, jevec, [jnp.log])[0]

    jt, jest = _jit(reference)(jlo.to_linear_operator(jnp.asarray(a)), jnp.asarray(probes))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(est), float(jest), rtol=1e-10)
    exact = float(np.linalg.slogdet(a)[1])
    assert abs(float(est) - exact) / abs(exact) < 0.1


def test_arithmetic_and_shape_conveniences():
    a, b = _spd(2, 5, 5.0), _spd(3, 5, 5.0)
    opa, opb = tlo.to_linear_operator(torch.tensor(a)), tlo.to_linear_operator(torch.tensor(b))
    np.testing.assert_allclose(opa.add(opb, alpha=2.5).to_dense().numpy(), a + 2.5 * b, rtol=1e-12)
    np.testing.assert_allclose(opa.sub(opb).to_dense().numpy(), a - b, rtol=1e-12)
    np.testing.assert_allclose(opa.div(4.0).to_dense().numpy(), a / 4.0, rtol=1e-12)
    x = torch.tensor(np.random.default_rng(4).normal(size=(2, 3, 4, 4)))
    op, jop = tlo.to_linear_operator(x), jlo.to_linear_operator(jnp.asarray(x.numpy()))
    for name in ("dim", "ndimension", "numel"):
        assert getattr(op, name)() == getattr(jop, name)()
    assert (op.batch_dim, len(op), op.size(), op.size(-1)) == (jop.batch_dim, len(jop), jop.size(), jop.size(-1))
    assert op.reshape(-1, 2, 3, 4, 4).shape == (1, 2, 3, 4, 4)
    assert tlo.to_linear_operator(x[0, 0]).t().shape == (4, 4)
    with pytest.raises(RuntimeError):
        op.t()
    with pytest.raises(TypeError):
        len(tlo.to_linear_operator(x[0, 0]))


def test_evaluate_kernel_casts_and_elementwise_contract():
    d = tlo.DiagLinearOperator(torch.tensor([1.0, 4.0, 9.0], dtype=torch.float64))
    assert isinstance(d.evaluate_kernel(), tlo.DiagLinearOperator)
    np.testing.assert_allclose(d.sqrt().diagonal().numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(d.numpy(), np.diag([1.0, 4.0, 9.0]))
    assert d.half().dtype == torch.float16 and d.bfloat16().dtype == torch.bfloat16
    dense = tlo.to_linear_operator(torch.eye(3, dtype=torch.float64))
    for name in ("abs", "exp", "log", "sqrt", "inverse"):
        with pytest.raises(NotImplementedError):
            getattr(dense, name)()


def test_detach_and_requires_grad_in_place():
    a = torch.tensor(_spd(5, 4, 4.0), requires_grad=True)
    op = tlo.to_linear_operator(a * 2.0)
    assert op.to_dense().requires_grad
    assert op.detach_() is op and not op.to_dense().requires_grad
    np.testing.assert_array_equal(op.clone().to_dense().numpy(), 2.0 * a.detach().numpy())
    leaf = tlo.to_linear_operator(torch.tensor(_spd(6, 4, 4.0)))
    assert leaf.requires_grad_() is leaf and leaf.to_dense().requires_grad
    leaf.requires_grad_(False)
    assert not leaf.to_dense().requires_grad


def test_log_det_aliases_warn_and_match_jax():
    a, rhs = _spd(7, 4, 4.0), np.random.default_rng(8).normal(size=(4, 2))
    op = tlo.to_linear_operator(torch.tensor(a))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ld = op.log_det()
        iq, ld2 = op.inv_quad_log_det(torch.tensor(rhs), logdet=True)
    assert sum(issubclass(w.category, DeprecationWarning) for w in rec) == 2
    jop = jlo.to_linear_operator(jnp.asarray(a))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jld = jop.log_det()
        jiq, _ = jop.inv_quad_log_det(jnp.asarray(rhs), logdet=True)
    np.testing.assert_allclose(float(ld), float(jld), rtol=1e-10)
    np.testing.assert_allclose(float(ld2), float(jld), rtol=1e-10)
    np.testing.assert_allclose(float(iq), float(jiq), rtol=1e-10)
    assert tlo.settings.stable_qr_cpu_threshold is tlo.settings.stable_qr_host_threshold


def test_solve_base_and_dsmm_match_jax():
    """``functions.solve_base`` (the differentiable solve under ``solve``)
    and the top-level ``dsmm`` (an interpolation matrix by gather and
    scatter-add) against the JAX package in f64."""
    a, b = _spd(9, 6, 6.0), np.random.default_rng(10).normal(size=(6, 2))
    at = torch.tensor(a, requires_grad=True)
    x = tlo.functions.solve_base(tlo.DenseLinearOperator(at), torch.tensor(b))
    np.testing.assert_allclose(x.detach().numpy(), np.linalg.solve(a, b), rtol=1e-10)
    (ga,) = torch.autograd.grad(x.sum(), at)
    w = np.linalg.solve(a.T, np.ones_like(b))
    np.testing.assert_allclose(ga.numpy(), -w @ np.linalg.solve(a, b).T, rtol=1e-9, atol=1e-12)
    rng = np.random.default_rng(11)
    idx, val, dense = rng.integers(0, 7, size=(5, 2)), rng.normal(size=(5, 2)), rng.normal(size=(7, 3))
    got = tlo.dsmm(tlo.InterpolationMatrix(torch.tensor(idx), torch.tensor(val), 7), torch.tensor(dense))
    want = jlo.dsmm(jlo.InterpolationMatrix(jnp.asarray(idx), jnp.asarray(val), 7), jnp.asarray(dense))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_psd_sum_samples_by_terms():
    """A PSD sum draws each term's samples from the caller's generator in
    turn: the same draws as sampling the terms one after the other."""
    a, b = _spd(12, 5, 1.0), _spd(13, 5, 1.0)
    terms = (tlo.DenseLinearOperator(torch.tensor(a)), tlo.DenseLinearOperator(torch.tensor(b)))
    op = tlo.PsdSumLinearOperator(terms)
    np.testing.assert_allclose(op.to_dense().numpy(), a + b, rtol=1e-12)
    got = op.zero_mean_mvn_samples(4, generator=torch.Generator().manual_seed(14))
    g = torch.Generator().manual_seed(14)
    want = terms[0].zero_mean_mvn_samples(4, generator=g) + terms[1].zero_mean_mvn_samples(4, generator=g)
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_cholesky_utilities_match_jax():
    """``blocked_cholesky`` (ragged last block) and ``psd_safe_cholesky_ex``
    (a batch with one element that needs jitter) against the JAX package."""
    a = _spd(15, 70, 1.0)
    got = tlo.utils.blocked_cholesky(torch.tensor(a), block=32)
    want = _jit(lambda m: jlo.utils.cholesky.blocked_cholesky(m, block=32))(jnp.asarray(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    bad = np.ones((3, 3))  # rank one: needs jitter
    batch = np.stack([_spd(16, 3, 1.0), bad])
    res = tlo.utils.psd_safe_cholesky_ex(torch.tensor(batch), jitter=1e-6, max_tries=3)
    jres = jlo.utils.psd_safe_cholesky_ex(jnp.asarray(batch), jitter=1e-6, max_tries=3)
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))
    np.testing.assert_allclose(res.jitter.numpy(), np.asarray(jres.jitter), rtol=1e-12)
    np.testing.assert_allclose(res.factor.numpy(), np.asarray(jres.factor), rtol=1e-10, atol=1e-12)
    assert set(tlo.utils.pinverse.__dict__) >= {"stable_pinverse", "stable_qr"}
