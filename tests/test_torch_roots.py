"""The port's root-decomposition layer against the JAX package: Lanczos, the
roots and inverse roots of every method and structure, diagonalization,
CholLinearOperator, eigh_safe, and the roots' gradients.

Everything runs in float64 on the CPU from seeded numpy inputs.  A Lanczos or
eigendecomposition root is unique only up to the signs of its columns (the
eigenvectors of eigh), so roots are compared through their Gram matrices
R R^T, and gradients are taken of functions of R R^T.  Where both packages
draw a random start vector, the ``same_draws`` fixture makes the two draws
one numpy array.  Tolerances are relative to the largest entry: 1e-10 for
Lanczos (the same recurrence, summed in other orders), 1e-7 for roots and
gradients, 1e-8 where the computation is direct.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.operators import kernel as jkernel
from linear_operator_tpu.solvers.lanczos import lanczos_tridiag as j_lanczos
from linear_operator_tpu.utils.eigh import eigh_safe as j_eigh_safe
from linear_operator_tpu.utils.errors import NotPSDError as JNotPSD
from linear_operator_tpu_torch.operators import kernel as tkernel
from linear_operator_tpu_torch.solvers.lanczos import lanczos_tridiag as t_lanczos
from linear_operator_tpu_torch.utils.eigh import eigh_safe as t_eigh_safe
from linear_operator_tpu_torch.utils.errors import NotPSDError as TNotPSD
from test_torch_gp_slice import _Both, _close, _np, _spd
from test_torch_harness_common import _jit, one_torch_thread  # noqa: F401 (an autouse fixture)

N = 60  # the dense operators' size


@pytest.fixture
def same_draws(monkeypatch):
    """Both packages' normal draws (``jax.random.normal`` and ``torch.randn``)
    return one numpy array for each shape."""
    state = {}

    def draws(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in state:
            state[shape] = np.random.default_rng(len(state) + 30).normal(size=shape)
        return state[shape]

    def jax_draw(key, shape=(), dtype=jnp.float64):
        return jnp.asarray(draws(shape), dtype=dtype)

    def torch_draw(*size, dtype=None, device=None, generator=None):
        shape = size[0] if len(size) == 1 and not isinstance(size[0], int) else size
        return torch.from_numpy(draws(shape)).to(dtype=dtype or torch.get_default_dtype(), device=device)

    monkeypatch.setattr(jax.random, "normal", jax_draw)
    monkeypatch.setattr(torch, "randn", torch_draw)
    return draws


def _gram(root):
    root = _np(root)
    return root @ np.swapaxes(root, -1, -2)


def _dense_pair(a):
    return jlo.operators.DenseLinearOperator(jnp.asarray(a)), tlo.operators.DenseLinearOperator(torch.from_numpy(a))


# ---------------------------------------------------------------------------
# Lanczos
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [(), (2,)])
def test_lanczos_tridiag_matches_jax(batch):
    a = _spd(1, N) if not batch else np.stack([_spd(1, N), _spd(2, N)])
    init = np.random.default_rng(3).normal(size=(*batch, N))
    jq, jt = _jit(lambda i: j_lanczos(lambda v: jnp.asarray(a) @ v, 30, init_vecs=i))(jnp.asarray(init))
    ta = torch.from_numpy(a)
    tq, tt = t_lanczos(lambda v: ta @ v, 30, init_vecs=torch.from_numpy(init))
    assert tq.shape == (*batch, N, 30) and tt.shape == (*batch, 30, 30)
    _close(tq, jq, 1e-10)
    _close(tt, jt, 1e-10)


def test_lanczos_breakdown_matches_jax():
    """A rank-5 matrix plus 1e-9 I: the Krylov space of a generic start is
    invariant after 6 steps (range(B) and the start's remainder), so from
    there beta is 0, the diagonal repeats the last live alpha and Q's
    columns are 0."""
    b = np.random.default_rng(4).normal(size=(N, 5))
    a = b @ b.T + 1e-9 * np.eye(N)
    init = np.random.default_rng(5).normal(size=N)
    jq, jt = _jit(lambda i: j_lanczos(lambda v: jnp.asarray(a) @ v, 12, init_vecs=i))(jnp.asarray(init))
    ta = torch.from_numpy(a)
    tq, tt = t_lanczos(lambda v: ta @ v, 12, init_vecs=torch.from_numpy(init))
    _close(tq, jq, 1e-10)
    _close(tt, jt, 1e-10)
    diag, off = np.diagonal(_np(tt)), np.diagonal(_np(tt), 1)
    assert np.all(off[5:] == 0.0) and np.all(np.abs(off[:5]) > 1e-3)
    assert np.all(diag[6:] == diag[5])
    assert np.all(_np(tq)[:, 6:] == 0.0)


# ---------------------------------------------------------------------------
# Roots and inverse roots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["cholesky", "lanczos", "symeig"])
def test_dense_roots_match_jax(same_draws, method):
    """k = 30 Lanczos steps of a 60 x 60 operator: the roots are the
    projection's, the same in both packages."""
    a = _spd(6, N)
    jop, top = _dense_pair(a)
    with _Both(max_root_decomposition_size=30):
        jr = jop.root_decomposition(method=method).root.to_dense()
        tr = top.root_decomposition(method=method).root.to_dense()
        ji = jop.root_inv_decomposition(method=method).root.to_dense()
        ti = top.root_inv_decomposition(method=method).root.to_dense()
    assert tr.shape == jr.shape and ti.shape == ji.shape
    _close(_gram(tr), _gram(jr), 1e-7)
    _close(_gram(ti), _gram(ji), 1e-7)
    if method != "lanczos":  # exact: R R^T = K, S S^T = K^{-1}
        _close(_gram(tr), a, 1e-8)
        _close(_gram(ti), np.linalg.inv(a), 1e-8)


def test_default_method_follows_the_size_cutoff(same_draws):
    """Cholesky up to max_cholesky_size, Lanczos above it."""
    a = _spd(7, N)
    _, top = _dense_pair(a)
    assert type(top.root_decomposition()).__name__ == "CholLinearOperator"
    with _Both(max_cholesky_size=10, max_root_decomposition_size=N):
        jop, top = _dense_pair(a)
        tr = top.root_decomposition()
        assert type(tr).__name__ == "RootLinearOperator"
        _close(_gram(tr.root.to_dense()), _gram(_jit(lambda: jop.root_decomposition().root.to_dense())()), 1e-7)
        # k = n: exact, but for the jitter added to T
        _close(_gram(tr.root.to_dense()), a + tlo.settings.tridiagonal_jitter.value() * np.eye(N), 1e-10)


def _structured(name):
    rng = np.random.default_rng(8)
    d = rng.uniform(0.5, 2.0, size=(2, 7))
    tri = np.tril(rng.normal(size=(7, 7))) + 3.0 * np.eye(7)
    root = rng.normal(size=(7, 4))
    if name == "diag":
        return jlo.operators.DiagLinearOperator(jnp.asarray(d)), tlo.operators.DiagLinearOperator(torch.from_numpy(d))
    if name == "constant_diag":
        c = d[:, :1]
        return (jlo.operators.ConstantDiagLinearOperator(jnp.asarray(c), diag_shape=7),
                tlo.operators.ConstantDiagLinearOperator(torch.from_numpy(c), diag_shape=7))
    if name == "root":
        return jlo.operators.RootLinearOperator(jnp.asarray(root)), tlo.operators.RootLinearOperator(torch.from_numpy(root))
    if name == "chol":
        return (jlo.operators.CholLinearOperator(jlo.operators.TriangularLinearOperator(jnp.asarray(tri))),
                tlo.operators.CholLinearOperator(tlo.operators.TriangularLinearOperator(torch.from_numpy(tri))))
    return (jlo.operators.TriangularLinearOperator(jnp.asarray(tri)),
            tlo.operators.TriangularLinearOperator(torch.from_numpy(tri)))


@pytest.mark.parametrize("name", ["diag", "constant_diag", "root", "chol"])
def test_structural_roots_match_jax(name):
    jop, top = _structured(name)
    jr, tr = jop.root_decomposition(), top.root_decomposition()
    assert type(tr).__name__ == type(jr).__name__
    assert type(tr.root).__name__ == type(jr.root).__name__
    _close(tr.root.to_dense(), jr.root.to_dense(), 1e-12)
    _close(tr.to_dense(), top.to_dense(), 1e-12)
    if name != "root":  # a rank-4 root has no inverse
        jr, tr = jop.root_inv_decomposition(), top.root_inv_decomposition()
        assert type(tr.root).__name__ == type(jr.root).__name__
        _close(tr.root.to_dense(), jr.root.to_dense(), 1e-12)
        _close(tr.to_dense(), np.linalg.inv(_np(top.to_dense())), 1e-10)
        _close(top.inverse().to_dense(), jop.inverse().to_dense(), 1e-12)


def test_triangular_roots_raise():
    jop, top = _structured("triangular")
    for op, err in ((jop, JNotPSD), (top, TNotPSD)):
        with pytest.raises(err):
            op.root_decomposition()
        with pytest.raises(err):
            op.root_inv_decomposition()
    _close(top.inverse().to_dense(), jop.inverse().to_dense(), 1e-12)


def test_best_probe_pick_matches_jax():
    """Three start vectors, one per probe, in one batched loop; the pick is
    the probe whose inverse root best solves against the test vectors.  The
    three roots differ (k = 8 < n), so the pick matters."""
    a = _spd(9, N)
    jop, top = _dense_pair(a)
    init = np.random.default_rng(10).normal(size=(N, 3))
    test = np.random.default_rng(11).normal(size=(N, 2))
    with _Both(max_cholesky_size=0, max_root_decomposition_size=8):
        ji = _jit(lambda i, t: jop.root_inv_decomposition(i, t).root.to_dense())(jnp.asarray(init), jnp.asarray(test))
        ti = top.root_inv_decomposition(torch.from_numpy(init), torch.from_numpy(test)).root.to_dense()
        singles = [
            _gram(top.root_inv_decomposition(torch.from_numpy(init[:, p : p + 1])).root.to_dense())
            for p in range(3)
        ]
    _close(_gram(ti), _gram(ji), 1e-7)
    resid = [np.linalg.norm(a @ s @ test - test, axis=0).sum() for s in singles]
    assert np.ptp(resid) > 1e-3 * min(resid)
    _close(_gram(ti), singles[int(np.argmin(resid))], 1e-10)


@pytest.mark.parametrize("method", ["symeig", "lanczos"])
def test_diagonalization_matches_jax(same_draws, method):
    a = _spd(12, N)
    jop, top = _dense_pair(a)
    with _Both(max_root_decomposition_size=30):
        jw, jq = _jit(lambda: (lambda w, q: (w, q.to_dense()))(*jop.diagonalization(method=method)))()
        tw, tq = top.diagonalization(method=method)
    _close(tw, jw, 1e-8)
    tq, jq = _np(tq.to_dense()), _np(jq)
    _close(tq @ np.diag(_np(tw)) @ tq.T, jq @ np.diag(_np(jw)) @ jq.T, 1e-7)


def test_eigh_eigvalsh_svd_match_jax():
    a = _spd(13, 20)
    jop, top = _dense_pair(a)
    (jw, jv), (tw, tv) = jop.eigh(), top.eigh()
    _close(tw, jw, 1e-12)
    _close(np.abs(_np(tv.to_dense())), np.abs(_np(jv.to_dense())), 1e-8)
    _close(top.eigvalsh(), jop.eigvalsh(), 1e-12)
    (ju, js, jvv), (tu, ts, tvv) = jop.svd(), top.svd()
    _close(ts, js, 1e-12)
    _close(_np(tu.to_dense()) @ np.diag(_np(ts)) @ _np(tvv.to_dense()).T, a, 1e-12)


@pytest.mark.parametrize("cholesky_size", [0, None])
def test_batched_dense_step_matches_jax(same_draws, cholesky_size):
    """The JAX benchmark's config 2 (``bench.py:bench_batched_dense``) at b = 4,
    n = 96: inv_quad_logdet and the root of a batch of dense SPD matrices.
    Under max_cholesky_size(0) the stochastic CG + SLQ path (the same probes
    in both packages) and a Lanczos root of k = n steps; under the default
    settings the Cholesky path and the Cholesky root.  No kernel runs."""
    b, n = 4, 96
    rng = np.random.default_rng(19)
    a = rng.normal(size=(b, n, n)) / np.sqrt(n)
    mats = a @ np.swapaxes(a, -1, -2) + 2.0 * np.eye(n)
    rhs = rng.normal(size=(b, n, 3))
    sizes = {} if cholesky_size is None else dict(max_cholesky_size=cholesky_size)

    def jstep(m, r):
        op = jlo.operators.DenseLinearOperator(m)
        iq, ld = jlo.inv_quad_logdet(op, r, logdet=True, key=jax.random.PRNGKey(2))
        return iq, ld, op.root_decomposition().root.to_dense()

    with _Both(**sizes):
        jiq, jld, jroot = _jit(jstep)(jnp.asarray(mats), jnp.asarray(rhs))
        op = tlo.operators.DenseLinearOperator(torch.from_numpy(mats))
        tiq, tld = tlo.inv_quad_logdet(op, torch.from_numpy(rhs), logdet=True, generator=torch.Generator())
        troot = op.root_decomposition(generator=torch.Generator()).root.to_dense()
    assert tiq.shape == tld.shape == (b,) and troot.shape == jroot.shape
    _close(tiq, jiq, 1e-7)
    _close(tld, jld, 1e-7)
    _close(_gram(troot), _gram(jroot), 1e-7)
    if cholesky_size is None:  # exact
        _close(tld, np.linalg.slogdet(mats)[1], 1e-10)
        _close(_gram(troot), mats, 1e-10)


# ---------------------------------------------------------------------------
# CholLinearOperator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [(), (2,)])
def test_chol_operator_matches_jax(batch):
    rng = np.random.default_rng(14)
    tri = np.tril(rng.normal(size=(*batch, 9, 9))) + 3.0 * np.eye(9)
    rhs = rng.normal(size=(*batch, 9, 2))
    jop = jlo.operators.CholLinearOperator(jlo.operators.TriangularLinearOperator(jnp.asarray(tri)))
    top = tlo.operators.CholLinearOperator(tlo.operators.TriangularLinearOperator(torch.from_numpy(tri)))
    k = tri @ np.swapaxes(tri, -1, -2)
    _close(top.to_dense(), k, 1e-12)
    jsol, (jiq, jld), jinv = _jit(lambda r: (jlo.solve(jop, r), jlo.inv_quad_logdet(jop, r, logdet=True),
                                             jop.inverse().to_dense()))(jnp.asarray(rhs))
    _close(tlo.solve(top, torch.from_numpy(rhs)), jsol, 1e-10)
    _close(tlo.solve(top, torch.from_numpy(rhs)), np.linalg.solve(k, rhs), 1e-10)
    tiq, tld = tlo.inv_quad_logdet(top, torch.from_numpy(rhs), logdet=True)
    _close(tiq, jiq, 1e-10)
    _close(tld, jld, 1e-10)
    _close(tld, np.linalg.slogdet(k)[1], 1e-10)
    _close(top.inverse().to_dense(), jinv, 1e-10)
    _close(top.inverse().to_dense(), np.linalg.inv(k), 1e-10)
    assert top.inverse().root.upper and not top.cholesky(upper=False).upper


def test_chol_operator_takes_a_raw_triangle_with_a_warning():
    tri = np.tril(np.random.default_rng(15).normal(size=(5, 5))) + 2.0 * np.eye(5)
    for t, upper in ((tri, False), (tri.T.copy(), True)):
        with pytest.warns(DeprecationWarning):
            op = tlo.operators.CholLinearOperator(torch.from_numpy(t))
        assert op.root.upper == upper
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
        tlo.operators.CholLinearOperator(torch.ones(5, 5, dtype=torch.float64))
    with pytest.raises(TypeError):
        tlo.operators.CholLinearOperator(tlo.operators.DenseLinearOperator(torch.from_numpy(tri)))


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def test_eigh_safe_gradient_at_a_degenerate_spectrum():
    """f(A) = sum(B o V exp(W) V^T), with B = A0^2 + I held constant, does not
    change when the eigenvectors of a repeated eigenvalue rotate among
    themselves, and, B commuting with A0, its gradient at A0 needs no
    within-eigenspace term.  At a spectrum with two double eigenvalues the
    plain eigh backward divides by gaps of ~1e-16; eigh_safe zeroes that
    gauge term, as the JAX package's JVP does: the gradient is finite, equal
    to JAX's, and equal to central differences of f along symmetric
    directions."""
    rng = np.random.default_rng(16)
    q, _ = np.linalg.qr(rng.normal(size=(5, 5)))
    a = q @ np.diag([1.0, 1.0, 2.0, 3.0, 3.0]) @ q.T
    a = 0.5 * (a + a.T)
    b = a @ a + np.eye(5)

    def jf(m):
        w, v = j_eigh_safe(m)
        return jnp.sum(jnp.asarray(b) * ((v * jnp.exp(w)) @ v.T))

    want = _jit(jax.grad(jf))(jnp.asarray(a))
    t = torch.from_numpy(a).requires_grad_()
    w, v = t_eigh_safe(t)
    torch.sum(torch.from_numpy(b) * ((v * torch.exp(w)) @ v.T)).backward()
    assert torch.isfinite(t.grad).all()
    _close(t.grad, want, 1e-8)

    def f(m):
        w_, v_ = np.linalg.eigh(m)
        return np.sum(b * ((v_ * np.exp(w_)) @ v_.T))

    eps, fd = 1e-5, np.zeros((5, 5))
    for i in range(5):
        for j in range(5):
            e = np.zeros((5, 5))
            e[i, j] += 0.5 * eps
            e[j, i] += 0.5 * eps
            fd[i, j] = (f(a + e) - f(a - e)) / (2 * eps)
    _close(t.grad, fd, 1e-6)


def _kernel_pair(x, dtype=np.float64):
    kw = dict(lengthscale=0.7, outputscale=1.3, block_rows=64, materialize_threshold=None)
    jop = jkernel.rbf_kernel_operator(jnp.asarray(x), **kw).add_diagonal(jnp.asarray(0.2))
    top = tkernel.rbf_kernel_operator(torch.from_numpy(x), use_fused_kernels=False, **kw)
    return jop, top.add_diagonal(torch.tensor(0.2, dtype=torch.float64))


@pytest.mark.parametrize("inverse", [False, True])
def test_lanczos_root_gradients_match_jax(same_draws, inverse):
    """d/d(raw lengthscale, raw outputscale, raw noise) of sum((b^T R)^2) for
    the root R of K (the root-only backward, 2k columns) and of the inverse
    root (4k columns), k = 20 steps of n = 150, on the blocked path with
    block_rows 64 (the per-block backward), against jax.grad."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(150, 3))
    b = rng.normal(size=150)
    raw = np.array([-0.3, 0.2, -1.5])

    def softplus(r, lib):
        return lib.logaddexp(r, 0.0 * r) + 1e-6

    def jloss(r):
        params = {"lengthscale": softplus(r[0], jnp), "outputscale": softplus(r[1], jnp)}
        op = jkernel.KernelLinearOperator(jnp.asarray(x), jnp.asarray(x), params, covar_func=jkernel.rbf_covar,
                                          block_rows=64, symmetric=True, materialize_threshold=None)
        op = op.add_diagonal(softplus(r[2], jnp))
        dec = op.root_inv_decomposition() if inverse else op.root_decomposition()
        return jnp.sum((jnp.asarray(b) @ dec.root.to_dense()) ** 2)

    r = torch.from_numpy(raw).requires_grad_()
    params = {"lengthscale": softplus(r[0], torch), "outputscale": softplus(r[1], torch)}
    op = tkernel.KernelLinearOperator(torch.from_numpy(x), torch.from_numpy(x), params, covar_func=tkernel.rbf_covar,
                                      block_rows=64, symmetric=True, materialize_threshold=None)
    op = op.add_diagonal(softplus(r[2], torch))
    with _Both(max_cholesky_size=0, max_root_decomposition_size=20):
        want_val, want = _jit(jax.value_and_grad(jloss))(jnp.asarray(raw))
        dec = op.root_inv_decomposition() if inverse else op.root_decomposition()
        loss = torch.sum((torch.from_numpy(b) @ dec.root.to_dense()) ** 2)
        loss.backward()
    _close(loss, want_val, 1e-7)
    assert torch.isfinite(r.grad).all()
    np.testing.assert_allclose(_np(r.grad), _np(want), rtol=0, atol=1e-7 * np.linalg.norm(_np(want)))


def test_second_derivative_of_a_lanczos_root_raises(same_draws):
    """As for solve: the backward's gradients carry no graph."""
    x = np.random.default_rng(18).normal(size=(40, 3))
    _, top = _kernel_pair(x)
    ls = top._linear_op.params["lengthscale"].requires_grad_()
    with tlo.settings.max_cholesky_size(0), tlo.settings.max_root_decomposition_size(10):
        root = top.root_inv_decomposition().root.to_dense()
    (g,) = torch.autograd.grad(torch.sum(root**2), ls, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g, ls)
