"""The port's structured operators against the JAX package: the Toeplitz
functions and operator (dense and FFT routes), the Kronecker family
(products, triangular and diagonal factors, an added constant or Kronecker
diagonal, the sum of two products) and the lazy product.

Seeded numpy inputs go to both packages; the JAX references are jitted.
Tolerances, relative to the largest entry (gradients: to their norm): 1e-8
for the closed forms and mat-vecs in float64, 1e-7 where CG or SLQ runs,
1e-4 in float32.  JAX's f32 eigendecompositions differ from torch's in their
last bits, which the Kronecker closed forms carry at ~1e-6.
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.models.ski import rbf_toeplitz_column as j_column
from linear_operator_tpu_torch.models.ski import rbf_toeplitz_column as t_column
from test_torch_gp_slice import _Both, _close, _grad_close, _np
from test_torch_roots import same_draws  # noqa: F401  (a fixture)
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

# the modules (each package's utils exports a function of the same name)
jtz = importlib.import_module("linear_operator_tpu.utils.toeplitz")
ttz = importlib.import_module("linear_operator_tpu_torch.utils.toeplitz")

F64 = 1e-8
CG64 = 1e-7
F32 = 1e-4


def _jit(fn):
    """``fn`` jitted with XLA's backend (LLVM) optimizations off: the same
    operations, compiled in a third of the time (compiling, not running, is
    what the references cost at these sizes)."""

    def call(*args):
        return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)

    return call


def _rng(seed):
    return np.random.default_rng(seed)


def _psd(seed, *batch, n=4):
    a = _rng(seed).normal(size=(*batch, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _spd_column(seed, n, *batch):
    """A positive definite symmetric Toeplitz column: an RBF column plus a
    little noise in the off-diagonal, a dominant diagonal."""
    c = np.exp(-0.5 * (np.arange(n) / (0.3 * n)) ** 2) + 0.01 * _rng(seed).normal(size=(*batch, n))
    c[..., 0] = 2.0
    return c


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype) if np.asarray(a).dtype.kind == "f" else torch.tensor(a)


def _j(a, dtype=jnp.float64):
    return jnp.asarray(a, dtype=dtype) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)


def _dense_toeplitz(c):
    n = c.shape[-1]
    i = np.arange(n)
    return c[..., np.abs(i[:, None] - i[None, :])]


class _SolverLog(logging.Handler):
    """The solver names ``settings.record_linalg`` logs under verbose_linalg,
    and CG's iteration counts."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.names, self.cg = [], []

    def emit(self, record):
        if record.msg.startswith("Running"):
            self.names.append(record.args[0])
        elif record.msg.startswith("linear_cg finished"):
            self.cg.append(int(record.args[0]))


@pytest.fixture
def solver_log():
    log = logging.getLogger("linear_operator_tpu_torch")
    handler = _SolverLog()
    old = log.level
    log.setLevel(logging.DEBUG)
    log.addHandler(handler)
    with tlo.settings.verbose_linalg(True):
        yield handler
    log.removeHandler(handler)
    log.setLevel(old)


# ---------------------------------------------------------------------------
# utils/toeplitz.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [7, 33])
def test_toeplitz_functions_match_jax(n):
    rng = _rng(n)
    col, row = rng.normal(size=(2, n)), rng.normal(size=(2, n))
    row[:, 0] = col[:, 0]
    v = rng.normal(size=(2, n, 3))
    u = rng.normal(size=(2, n, 3))
    i, j = rng.integers(0, n, size=(2, 11))

    @_jit
    def ref(col, row, v, u, i, j):
        return (
            jtz.toeplitz(col, row),
            jtz.sym_toeplitz(col),
            jtz.toeplitz_getitem(col, row, i, j),
            jtz.sym_toeplitz_getitem(col, i, j),
            jtz.toeplitz_matmul(col, row, v),
            jtz.toeplitz_matmul(col[0], row[0], v[0, :, 0]),
            jtz.sym_toeplitz_matmul(col, v),
            jtz.sym_toeplitz_derivative_quadratic_form(u, v),
            jtz.sym_toeplitz_derivative_quadratic_form(u[0, :, 0], v[0, :, 0]),
        )

    want = ref(*(_j(a) for a in (col, row, v, u, i, j)))
    tc, tr, tv, tu, ti, tj = (_t(a) for a in (col, row, v, u, i, j))
    got = (
        ttz.toeplitz(tc, tr),
        ttz.sym_toeplitz(tc),
        ttz.toeplitz_getitem(tc, tr, ti, tj),
        ttz.sym_toeplitz_getitem(tc, ti, tj),
        ttz.toeplitz_matmul(tc, tr, tv),
        ttz.toeplitz_matmul(tc[0], tr[0], tv[0, :, 0]),
        ttz.sym_toeplitz_matmul(tc, tv),
        ttz.sym_toeplitz_derivative_quadratic_form(tu, tv),
        ttz.sym_toeplitz_derivative_quadratic_form(tu[0, :, 0], tv[0, :, 0]),
    )
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, F64)
    # the FFT product is the dense one
    _close(got[4], _np(got[0]) @ v, F64)


def test_toeplitz_matmul_keeps_a_complex_operand():
    rng = _rng(3)
    col = rng.normal(size=9) + 1j * rng.normal(size=9)
    row = rng.normal(size=9) + 1j * rng.normal(size=9)
    row[0] = col[0]
    v = rng.normal(size=(9, 2))
    want = _jit(jtz.toeplitz_matmul)(jnp.asarray(col), jnp.asarray(row), jnp.asarray(v))
    got = ttz.toeplitz_matmul(torch.tensor(col), torch.tensor(row), torch.tensor(v))
    assert got.is_complex()
    _close(got, np.asarray(want), F64)


# ---------------------------------------------------------------------------
# operators/toeplitz.py
# ---------------------------------------------------------------------------


def _toeplitz_pair(c, dtype=np.float64):
    jdt, tdt = (jnp.float64, torch.float64) if dtype == np.float64 else (jnp.float32, torch.float32)
    return jlo.operators.ToeplitzLinearOperator(_j(c, jdt)), tlo.operators.ToeplitzLinearOperator(_t(c, tdt))


@pytest.mark.parametrize("batch", [(), (2,)])
@pytest.mark.parametrize("route", ["dense", "fft"])
@pytest.mark.parametrize("n", [7, 33])
def test_toeplitz_operator_matches_jax(n, route, batch):
    c = _spd_column(n, n, *batch)
    v = _rng(n + 1).normal(size=(*batch, n, 3))
    fft_min = 0 if route == "fft" else 4096

    def ref(c, v):
        op = jlo.operators.ToeplitzLinearOperator(c)
        return op @ v, op._t_matmul(v), op.to_dense(), op.diagonal()

    def grads(c, v):
        return jax.grad(lambda c: jnp.sum(jnp.sin(jlo.operators.ToeplitzLinearOperator(c) @ v)))(c)

    with jlo.settings.toeplitz_fft_min_size(fft_min):
        want, want_g = _jit(lambda c, v: (ref(c, v), grads(c, v)))(_j(c), _j(v))
    tc = _t(c).requires_grad_(True)
    op = tlo.operators.ToeplitzLinearOperator(tc)
    with tlo.settings.toeplitz_fft_min_size(fft_min):
        assert op._uses_fft() == (route == "fft")
        got = (op @ _t(v), op._t_matmul(_t(v)), op.to_dense(), op.diagonal())
        torch.sum(torch.sin(op @ _t(v))).backward()
    for g, w in zip(got, want):
        _close(g, w, F64)
    _close(got[0], _dense_toeplitz(c) @ v, F64)
    _grad_close(_np(tc.grad), want_g, F64)


@pytest.mark.parametrize("route", ["dense", "fft"])
def test_toeplitz_operator_float32_matches_jax(route):
    c = _spd_column(5, 33).astype(np.float32)
    v = _rng(6).normal(size=(33, 2)).astype(np.float32)
    fft_min = 0 if route == "fft" else 4096
    jop, top = _toeplitz_pair(c, np.float32)
    with jlo.settings.toeplitz_fft_min_size(fft_min):
        want = _jit(lambda c, v: jlo.operators.ToeplitzLinearOperator(c) @ v)(jop.column, jnp.asarray(v))
    with tlo.settings.toeplitz_fft_min_size(fft_min):
        got = top @ torch.tensor(v)
    assert got.dtype == torch.float32
    _close(got, want, F32)


def test_toeplitz_indexing_matches_jax():
    c = _spd_column(8, 9, 2)
    jop, top = _toeplitz_pair(c)
    rows, cols, bidx = np.array([0, 3, 8, 5]), np.array([2, 3, 0, 7]), np.array([1, 0, 1, 1])
    _close(top._get_indices(_t(rows), _t(cols), _t(bidx)), jop._get_indices(_j(rows), _j(cols), _j(bidx)), F64)
    sub = top._getitem(slice(2, 7), slice(2, 7))
    assert isinstance(sub, tlo.operators.ToeplitzLinearOperator)
    _close(sub.to_dense(), jop._getitem(slice(2, 7), slice(2, 7)).to_dense(), F64)
    sub = top._getitem(slice(1, 5), slice(0, 6), 1)
    assert isinstance(sub, tlo.operators.DenseLinearOperator)
    _close(sub.to_dense(), jop._getitem(slice(1, 5), slice(0, 6), 1).to_dense(), F64)
    one = tlo.operators.ToeplitzLinearOperator(_t(c[0]))
    expanded = one._expand_batch((3,))
    assert isinstance(expanded, tlo.operators.ToeplitzLinearOperator) and expanded.shape == (3, 9, 9)
    _close(expanded.to_dense(), np.broadcast_to(_dense_toeplitz(c[0]), (3, 9, 9)), F64)


def test_small_toeplitz_takes_the_dense_route(monkeypatch):
    from linear_operator_tpu_torch.operators import toeplitz as tp_mod

    calls = []
    monkeypatch.setattr(tp_mod, "toeplitz_matmul", lambda c, r: calls.append(1) or ttz.sym_toeplitz_matmul(c, r))
    op = tlo.operators.ToeplitzLinearOperator(_t(_spd_column(1, 8)))
    rhs = torch.ones(8, 2, dtype=torch.float64)
    with tlo.settings.toeplitz_fft_min_size(64):
        op @ rhs
    assert not calls
    with tlo.settings.toeplitz_fft_min_size(4):
        op @ rhs
    assert calls
    with tlo.settings.toeplitz_fft_min_size(4), tlo.settings.use_toeplitz(False):
        assert not op._uses_fft()


# ---------------------------------------------------------------------------
# operators/kronecker.py, kronecker_added_diag.py, sum_kronecker.py
# ---------------------------------------------------------------------------


def _factors(sizes, batch=(), seed=0):
    return [_psd(seed + i, *batch, n=n) for i, n in enumerate(sizes)]


def _jkron(mats):
    return jlo.operators.KroneckerProductLinearOperator(tuple(jlo.operators.DenseLinearOperator(m) for m in mats))


def _tkron(mats):
    return tlo.operators.KroneckerProductLinearOperator(tuple(tlo.operators.DenseLinearOperator(m) for m in mats))


KRON_CASES = [((3, 4), ()), ((2, 3, 4), ()), ((3, 4), (2,))]


@pytest.mark.parametrize("sizes,batch", KRON_CASES)
def test_kronecker_product_matches_jax(sizes, batch):
    mats = _factors(sizes, batch)
    n = int(np.prod(sizes))
    rhs = _rng(9).normal(size=(*batch, n, 2))
    rows, cols = _rng(10).integers(0, n, size=(2, 7))
    bidx = [_rng(11).integers(0, b, size=7) for b in batch]

    @_jit
    def ref(mats, rhs, rows, cols, *bidx):
        op = _jkron(mats)
        evals, evecs = op.eigh()
        chol = op.cholesky().to_dense()
        iq, ld = op.inv_quad_logdet(rhs, logdet=True)
        return dict(
            mm=op @ rhs, tmm=op._t_matmul(rhs), dense=op.to_dense(), diag=op.diagonal(),
            solve=op.solve(rhs), iq=iq, ld=ld, evals=evals, recon=evecs.to_dense() @ (evals[..., :, None] * jnp.swapaxes(evecs.to_dense(), -1, -2)),
            eigvalsh=op.eigvalsh(), inverse=op.inverse().to_dense(), chol=chol,
            root=op._root_structure().to_dense(), root_inv=op._root_inv_structure().to_dense(),
            t=op.mT.to_dense(), gi=op._get_indices(rows, cols, *bidx),
        )

    want = ref([_j(m) for m in mats], _j(rhs), _j(rows), _j(cols), *map(_j, bidx))
    top = _tkron([_t(m) for m in mats])
    evals, evecs = top.eigh()
    iq, ld = top.inv_quad_logdet(_t(rhs), logdet=True)
    got = dict(
        mm=top @ _t(rhs), tmm=top._t_matmul(_t(rhs)), dense=top.to_dense(), diag=top.diagonal(),
        solve=top.solve(_t(rhs)), iq=iq, ld=ld, evals=evals, recon=evecs.to_dense() @ (evals[..., :, None] * evecs.to_dense().mT),
        eigvalsh=top.eigvalsh(), inverse=top.inverse().to_dense(), chol=top.cholesky().to_dense(),
        root=top._root_structure().to_dense(), root_inv=top._root_inv_structure().to_dense(), t=top.mT.to_dense(),
        gi=top._get_indices(_t(rows), _t(cols), *map(_t, bidx)),
    )
    dense = _np(want["dense"])
    _close(got["mm"], dense @ rhs, F64)
    for key in want:
        if key in ("root", "root_inv"):  # roots only up to their columns' signs
            g, w = _np(got[key]), _np(want[key])
            _close(g @ np.swapaxes(g, -1, -2), w @ np.swapaxes(w, -1, -2), F64)
        else:
            _close(got[key], want[key], F64)
    # the Cholesky factor is the Kronecker product's own, triangular
    chol = top.cholesky()
    assert isinstance(chol.tensor, tlo.operators.KroneckerProductTriangularLinearOperator)
    _close(chol._solve_structure(_t(rhs)), np.linalg.solve(_np(got["chol"]), rhs), F64)


def test_kronecker_mixed_batch_indices_match_jax():
    """An unbatched factor beside a batched one: the product's batch indices
    reach the unbatched factor after it is expanded."""
    a, b = _psd(1, n=3), _psd(2, 2, n=4)
    rows, cols, bidx = _rng(3).integers(0, 12, size=(3, 5))
    bidx = bidx % 2
    want = _jkron([_j(a), _j(b)])._get_indices(_j(rows), _j(cols), _j(bidx))
    got = _tkron([_t(a), _t(b)])._get_indices(_t(rows), _t(cols), _t(bidx))
    _close(got, want, F64)


def test_kronecker_gradients_match_jax():
    mats = _factors((3, 4), seed=20)
    rhs = _rng(21).normal(size=(12, 2))

    def jloss(a, b):
        op = _jkron([a, b])
        iq, ld = op.inv_quad_logdet(_j(rhs), logdet=True)
        return jnp.sum(iq) + ld + jnp.sum(op.solve(_j(rhs)) ** 2) + jnp.sum(op.diagonal())

    want = _jit(jax.grad(jloss, argnums=(0, 1)))(*(_j(m) for m in mats))
    ta, tb = (_t(m).requires_grad_(True) for m in mats)
    op = _tkron([ta, tb])
    iq, ld = op.inv_quad_logdet(_t(rhs), logdet=True)
    (torch.sum(iq) + ld + torch.sum(op.solve(_t(rhs)) ** 2) + torch.sum(op.diagonal())).backward()
    _grad_close(_np(ta.grad), want[0], F64)
    _grad_close(_np(tb.grad), want[1], F64)


def test_kronecker_triangular_and_diag_factors_match_jax():
    rng = _rng(30)
    la, lb = np.tril(_psd(31, n=3)), np.tril(_psd(32, n=4))
    d1, d2 = rng.uniform(0.5, 2.0, size=3), rng.uniform(0.5, 2.0, size=4)
    rhs = rng.normal(size=(12, 2))

    @_jit
    def ref(la, lb, d1, d2, rhs):
        tri = jlo.operators.KroneckerProductTriangularLinearOperator(
            (jlo.operators.TriangularLinearOperator(la), jlo.operators.TriangularLinearOperator(lb))
        )
        kd = jlo.operators.KroneckerProductDiagLinearOperator(
            (jlo.operators.DiagLinearOperator(d1), jlo.operators.DiagLinearOperator(d2))
        )
        iq, ld = kd.inv_quad_logdet(rhs, logdet=True)
        return dict(
            tri_mm=tri @ rhs, tri_solve=tri._solve_structure(rhs), tri_t=tri.mT.to_dense(),
            kd_mm=kd @ rhs, kd_solve=kd._solve_structure(rhs), kd_iq=iq, kd_ld=ld, kd_neg=(kd * -1.0).to_dense(),
            kd_inv=kd.inverse().to_dense(), kd_sqrt=kd.sqrt().to_dense(), kd_root=kd._root_structure().to_dense(),
            kd_root_inv=kd._root_inv_structure().to_dense(), kd_chol=kd.cholesky().to_dense(),
            kd_chol_solve=kd.cholesky()._solve_structure(rhs),
        )

    want = ref(*(_j(a) for a in (la, lb, d1, d2, rhs)))
    tops = tlo.operators
    tri = tops.KroneckerProductTriangularLinearOperator(
        tops.TriangularLinearOperator(_t(la)), tops.TriangularLinearOperator(_t(lb))
    )
    kd = tops.KroneckerProductDiagLinearOperator([tops.DiagLinearOperator(_t(d1)), tops.DiagLinearOperator(_t(d2))])
    iq, ld = kd.inv_quad_logdet(_t(rhs), logdet=True)
    got = dict(
        tri_mm=tri @ _t(rhs), tri_solve=tri._solve_structure(_t(rhs)), tri_t=tri.mT.to_dense(),
        kd_mm=kd @ _t(rhs), kd_solve=kd._solve_structure(_t(rhs)), kd_iq=iq, kd_ld=ld, kd_neg=(kd * -1.0).to_dense(),
        kd_inv=kd.inverse().to_dense(), kd_sqrt=kd.sqrt().to_dense(), kd_root=kd._root_structure().to_dense(),
        kd_root_inv=kd._root_inv_structure().to_dense(), kd_chol=kd.cholesky().to_dense(),
        kd_chol_solve=kd.cholesky()._solve_structure(_t(rhs)),
    )
    for key in want:
        _close(got[key], want[key], F64)
    assert tri._inherently_triangular and kd._inherently_triangular
    assert tri.mT.upper and not tri.upper
    # |kron(d)| by factors; a triangular Kronecker product is not PSD
    neg = tops.KroneckerProductDiagLinearOperator([tops.DiagLinearOperator(-_t(d1)), tops.DiagLinearOperator(_t(d2))])
    _close(neg.abs().diagonal(), np.kron(d1, d2), F64)
    with pytest.raises(tlo.utils.NotPSDError):
        tri.cholesky()


@pytest.mark.parametrize("kind", ["diag", "constant"])
def test_triangular_of_a_diagonal_keeps_its_structure_and_matches_jax(kind, monkeypatch):
    """A diagonal is inherently triangular: Triangular(Diag) multiplies and
    solves through the diagonal, never densifying, as in the JAX package."""
    rng = _rng(35)
    d = rng.uniform(0.5, 2.0, size=(2, 5))
    rhs = rng.normal(size=(2, 5, 3))

    def make(ops, arr):
        if kind == "constant":
            return ops.ConstantDiagLinearOperator(arr[..., :1], diag_shape=5)
        return ops.DiagLinearOperator(arr)

    @_jit
    def ref(d, rhs):
        tri = jlo.operators.TriangularLinearOperator(make(jlo.operators, d))
        return dict(mm=tri @ rhs, tmm=tri._t_matmul(rhs), solve=tri._solve_structure(rhs), dense=tri.to_dense(),
                    t=tri.mT.to_dense(), diag=tri.diagonal())

    want = ref(_j(d), _j(rhs))
    tri = tlo.operators.TriangularLinearOperator(make(tlo.operators, _t(d)))
    assert tri._structured and tri.mT._structured
    with monkeypatch.context() as patch:
        patch.setattr(type(tri), "to_dense", lambda self: pytest.fail("Triangular(Diag) densified"))
        got = dict(mm=tri @ _t(rhs), tmm=tri._t_matmul(_t(rhs)), solve=tri._solve_structure(_t(rhs)), diag=tri.diagonal())
    got.update(dense=tri.to_dense(), t=tri.mT.to_dense())
    for key in want:
        _close(got[key], want[key], F64)


def _added_diag_pair(kind, mats, seed=40):
    """(JAX, port, dense) for a Kronecker product plus a diagonal of
    ``kind``: "constant", "diag" (unstructured), "kron" (matching factors),
    "kron_mismatch" (the same count, other sizes)."""
    rng = _rng(seed)
    sizes = [m.shape[-1] for m in mats]
    n = int(np.prod(sizes))
    jk, tk = _jkron([_j(m) for m in mats]), _tkron([_t(m) for m in mats])
    dense = _np(jk.to_dense())
    if kind == "constant":
        return jk.add_diagonal(_j(0.7)), tk.add_diagonal(_t(0.7)), dense + 0.7 * np.eye(n)
    if kind == "diag":
        d = rng.uniform(0.5, 1.5, size=n)
        return jk.add_diagonal(_j(d)), tk.add_diagonal(_t(d)), dense + np.diag(d)
    ds = [rng.uniform(0.5, 1.5, size=s) for s in (sizes if kind == "kron" else sizes[::-1])]
    jd = jlo.operators.KroneckerProductDiagLinearOperator(tuple(jlo.operators.DiagLinearOperator(_j(d)) for d in ds))
    td = tlo.operators.KroneckerProductDiagLinearOperator(tuple(tlo.operators.DiagLinearOperator(_t(d)) for d in ds))
    full = ds[0]
    for d in ds[1:]:
        full = np.kron(full, d)
    return jk + jd, tk + td, dense + np.diag(full)


@pytest.mark.parametrize("kind", ["constant", "kron"])
@pytest.mark.parametrize("sizes,batch", KRON_CASES)
def test_kronecker_added_diag_closed_forms_match_jax(sizes, batch, kind, solver_log):
    mats = _factors(sizes, batch, seed=50)
    jop, top, dense = _added_diag_pair(kind, mats)
    assert isinstance(top, tlo.operators.KroneckerProductAddedDiagLinearOperator)
    rhs = _rng(51).normal(size=(*batch, dense.shape[-1], 2))

    def ref(jop, rhs):
        iq, ld = jop.inv_quad_logdet(rhs, logdet=True)
        out = dict(solve=jop.solve(rhs), iq=iq, ld=ld, mm=jop @ rhs)
        if kind == "constant":
            out["root"] = jop._root_structure().to_dense()
            out["root_inv"] = jop._root_inv_structure().to_dense()
        return out

    with jlo.settings.max_cholesky_size(0):
        want = _jit(ref)(jop, _j(rhs))
    with tlo.settings.max_cholesky_size(0):
        iq, ld = top.inv_quad_logdet(_t(rhs), logdet=True)
        got = dict(solve=top.solve(_t(rhs)), iq=iq, ld=ld, mm=top @ _t(rhs))
        if kind == "constant":
            got["root"] = top._root_structure().to_dense()
            got["root_inv"] = top._root_inv_structure().to_dense()
        assert top.with_preconditioner() is top
    # exact: no CG, no SLQ, no dense Cholesky of the whole operator
    assert not [name for name in solver_log.names if name != "psd_safe_cholesky"], solver_log.names
    _close(got["solve"], np.linalg.solve(dense, rhs), F64)
    for key in want:
        if key.startswith("root"):
            g, w = _np(got[key]), _np(want[key])
            _close(g @ np.swapaxes(g, -1, -2), w @ np.swapaxes(w, -1, -2), F64)
        else:
            _close(got[key], want[key], F64)
    _close(got["ld"], np.linalg.slogdet(dense)[1], F64)


@pytest.mark.parametrize("kind", ["diag", "kron_mismatch"])
def test_kronecker_added_diag_without_closed_form_takes_cg_as_jax(kind, same_draws, solver_log):
    mats = _factors((2, 3), seed=60)
    jop, top, dense = _added_diag_pair(kind, mats)
    rhs = _rng(61).normal(size=(6, 2))
    assert top._solve_structure(_t(rhs)) is None and top._logdet_structure() is None
    assert top._inv_quad_logdet_structure(_t(rhs), True) is None
    settings = dict(max_cholesky_size=0, cg_tolerance=1e-10, max_cg_iterations=50, num_trace_samples=8)
    with _Both(**settings):
        jsolve, (jiq, jld) = _jit(
            lambda o, r: (o.solve(r), o.inv_quad_logdet(r, logdet=True, key=jax.random.PRNGKey(0)))
        )(jop, _j(rhs))
        tsolve = top.solve(_t(rhs))
        tiq, tld = top.inv_quad_logdet(_t(rhs), logdet=True, generator=torch.Generator().manual_seed(0))
    assert "linear_cg" in solver_log.names or solver_log.cg
    _close(tsolve, jsolve, CG64)
    _close(tsolve, np.linalg.solve(dense, rhs), CG64)
    _close(tiq, jiq, CG64)
    _close(tld, jld, CG64)


def test_kronecker_added_diag_gradients_match_jax():
    a0, b0 = _psd(70, n=3), _psd(71, n=4)
    rhs = _rng(72).normal(size=(12, 1))

    def jloss(s, c):
        op = _jkron([a0 * s, b0]).add_diagonal(c)
        iq, ld = op.inv_quad_logdet(_j(rhs), logdet=True)
        return jnp.sum(iq) + ld

    want = _jit(jax.grad(jloss, argnums=(0, 1)))(_j(1.3), _j(0.5))
    s, c = _t(1.3).requires_grad_(True), _t(0.5).requires_grad_(True)
    op = _tkron([_t(a0) * s, _t(b0)]).add_diagonal(c)
    iq, ld = op.inv_quad_logdet(_t(rhs), logdet=True)
    (torch.sum(iq) + ld).backward()
    _grad_close([_np(s.grad), _np(c.grad)], [want[0], want[1]], F64)
    # the dense formula
    K = np.kron(a0 * 1.3, b0) + 0.5 * np.eye(12)
    Kinv = np.linalg.inv(K)
    alpha = Kinv @ rhs
    dK_ds = np.kron(a0, b0)
    g_s = -alpha[:, 0] @ dK_ds @ alpha[:, 0] + np.trace(Kinv @ dK_ds)
    g_c = -alpha[:, 0] @ alpha[:, 0] + np.trace(Kinv)
    _grad_close([_np(s.grad), _np(c.grad)], [g_s, g_c], F64)


def test_kronecker_added_diag_algebra():
    mats = _factors((2, 3), seed=80)
    _, top, dense = _added_diag_pair("constant", mats)
    d = _rng(81).uniform(0.5, 1.0, size=6)
    more = top + tlo.operators.DiagLinearOperator(_t(d))
    assert isinstance(more, tlo.operators.KroneckerProductAddedDiagLinearOperator)
    _close(more.to_dense(), dense + np.diag(d), F64)
    _, kron_diag, kdense = _added_diag_pair("kron", mats)
    stacked = kron_diag + tlo.operators.DiagLinearOperator(_t(d))
    assert type(stacked) is tlo.operators.AddedDiagLinearOperator
    _close(stacked.to_dense(), kdense + np.diag(d), F64)
    with pytest.raises(TypeError):
        tlo.operators.KroneckerProductAddedDiagLinearOperator(tlo.operators.DenseLinearOperator(_t(dense)), top.operators[1])


def test_sum_kronecker_matches_jax():
    a, b, c, d = (_psd(90 + i, n=n) for i, n in enumerate((3, 4, 3, 4)))
    rhs = _rng(95).normal(size=(12, 2))

    @_jit
    def ref(a, b, c, d, rhs):
        op = _jkron([a, b]) + _jkron([c, d])
        iq, ld = op.inv_quad_logdet(rhs, logdet=True)
        return dict(mm=op @ rhs, solve=op._solve_structure(rhs), ld=op._logdet_structure(), iq=iq, ld2=ld,
                    root=op._root_structure().to_dense())

    want = ref(*(_j(m) for m in (a, b, c, d, rhs)))
    top = _tkron([_t(a), _t(b)]) + _tkron([_t(c), _t(d)])
    assert isinstance(top, tlo.operators.SumKroneckerLinearOperator)
    iq, ld = top.inv_quad_logdet(_t(rhs), logdet=True)
    got = dict(mm=top @ _t(rhs), solve=top._solve_structure(_t(rhs)), ld=top._logdet_structure(), iq=iq, ld2=ld,
               root=top._root_structure().to_dense())
    dense = np.kron(a, b) + np.kron(c, d)
    for key in ("mm", "solve", "ld", "iq", "ld2"):
        _close(got[key], want[key], F64)
    r = _np(got["root"])
    _close(r @ r.T, dense, F64)
    _close(got["solve"], np.linalg.solve(dense, rhs), F64)
    with pytest.raises(ValueError):
        tlo.operators.SumKroneckerLinearOperator((_tkron([_t(a), _t(b), _t(c)]), _tkron([_t(c), _t(d)])))


def test_matmul_operator_matches_jax():
    a, b = _rng(100).normal(size=(2, 5, 4)), _rng(101).normal(size=(2, 4, 6))
    rhs = _rng(102).normal(size=(2, 6, 3))
    jop = jlo.operators.MatmulLinearOperator(_j(a), _j(b))
    top = tlo.operators.MatmulLinearOperator(_t(a), _t(b))
    _close(top @ _t(rhs), a @ b @ rhs, F64)
    lhs = _rng(103).normal(size=(2, 5, 2))
    _close(top._t_matmul(_t(lhs)), np.swapaxes(a @ b, -1, -2) @ lhs, F64)
    _close(top.to_dense(), jop.to_dense(), F64)
    sub = top._getitem(slice(1, 4), slice(0, 5), 1)
    _close(sub.to_dense(), jop._getitem(slice(1, 4), slice(0, 5), 1).to_dense(), F64)
    sq = tlo.operators.MatmulLinearOperator(_t(a[..., :4, :]), tlo.operators.DiagLinearOperator(_t(b[..., 0, :4])))
    _close(sq.diagonal(), np.einsum("bii->bi", a[..., :4, :] * b[..., 0, None, :4]), F64)
    _close(sq.to_dense(), a[..., :4, :] * b[..., 0, None, :4], F64)


# ---------------------------------------------------------------------------
# Config 4 at a small size: Kronecker(Toeplitz, Toeplitz) + 0.1 I
# ---------------------------------------------------------------------------


def _config4_step(pkg, mk, tdt, ls, y, m, h):
    """The JAX bench's config 4 step: sum(solve) + sum(iq) + sum(ld)."""
    ops = pkg.operators
    col1 = mk(m, h, ls, dtype=tdt)
    col2 = mk(m, h, ls * 1.3, dtype=tdt)
    op = ops.KroneckerProductLinearOperator((ops.ToeplitzLinearOperator(col1), ops.ToeplitzLinearOperator(col2)))
    op = op.add_diagonal(0.1)
    x = pkg.solve(op, y)
    iq, ld = pkg.inv_quad_logdet(op, y, logdet=True)
    return (x.sum() + iq.sum() + ld.sum()), x, iq, ld


def config4_closed_form(m: int, h: float, ls: float, y: np.ndarray):
    """The step's value and d/d(ls) in float64 from the factors'
    eigendecompositions, with dK/d(ls) written out: with K = T1 (x) T2 + cI,
    d total = -(w + x)^T K' x + tr(K^{-1} K'), w = K^{-1} 1, x = K^{-1} y."""
    d2 = ((np.arange(m)[:, None] - np.arange(m)[None, :]) * h) ** 2
    t1, t2 = np.exp(-0.5 * d2 / ls**2), np.exp(-0.5 * d2 / (1.3 * ls) ** 2)
    dt1, dt2 = t1 * d2 / ls**3, t2 * d2 / (1.3**2 * ls**3)  # d/d(ls) of each factor
    a, q1 = np.linalg.eigh(t1)
    b, q2 = np.linalg.eigh(t2)
    shifted = np.kron(a, b) + 0.1

    def kron_mv(left, right, v):  # (left (x) right) v for row-major v
        return (left @ v.reshape(m, m) @ right.T).reshape(-1)

    def solve(v):
        return kron_mv(q1, q2, kron_mv(q1.T, q2.T, v) / shifted)

    yv = y[:, 0]
    x, w = solve(yv), solve(np.ones(m * m))
    kx = kron_mv(dt1, t2, x) + kron_mv(t1, dt2, x)
    trace = np.sum(np.kron(np.diag(q1.T @ dt1 @ q1), b) / shifted) + np.sum(np.kron(a, np.diag(q2.T @ dt2 @ q2)) / shifted)
    total = x.sum() + x @ yv + np.sum(np.log(shifted))
    return total, -(w + x) @ kx + trace


@pytest.mark.parametrize("dtype,h", [(np.float64, 0.2), (np.float32, 0.5)])
def test_config4_step_and_lengthscale_gradient_match_jax(dtype, h, solver_log):
    """m = 30 (n = 900, above max_cholesky_size): the forward takes the
    closed forms; the solve's backward runs CG on op.mT, an unstructured sum,
    in both packages.  The backward is held with CG run to convergence: at
    the default tolerance both stop after the 10-iteration minimum, where a
    smooth kernel's Krylov space is nearly exhausted and the residual crosses
    CG's 1e-10 freeze threshold at a rounding's whim.  The grid spacing keeps
    the factors' spectra well separated for the dtype: inv_quad's gradient
    runs through the eigenvectors' derivative, which in float32 at spacing
    0.2 lies 1e-3 (port) and 3e-3 (JAX) from the closed form."""
    m = 30
    jdt, tdt = (jnp.float64, torch.float64) if dtype == np.float64 else (jnp.float32, torch.float32)
    y = _rng(110).normal(size=(m * m, 1)).astype(dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4

    def jstep(ls, y):
        total, x, iq, ld = _config4_step(jlo, j_column, jdt, ls, y, m, h)
        return total, (x, iq, ld)

    with jlo.settings.cg_tolerance(tol):
        (jtotal, (jx, jiq, jld)), jgrad = _jit(jax.value_and_grad(jstep, has_aux=True))(
            jnp.asarray(0.3, jdt), _j(y, jdt)
        )
    ls = torch.tensor(0.3, dtype=tdt, requires_grad=True)
    total, x, iq, ld = _config4_step(tlo, t_column, tdt, ls, _t(y, tdt), m, h)
    forward_names = list(solver_log.names)
    with tlo.settings.cg_tolerance(tol):
        total.backward()
    assert not [name for name in forward_names if name != "psd_safe_cholesky"], forward_names
    assert solver_log.cg, "the solve's backward runs CG on the transpose"
    rtol = F64 if dtype == np.float64 else F32
    for g, w in ((x, jx), (iq, jiq), (ld, jld), (total, jtotal)):
        _close(g, w, rtol)
    _grad_close(_np(ls.grad), jgrad, CG64 if dtype == np.float64 else F32)
    if dtype == np.float64:
        want_total, want_grad = config4_closed_form(m, h, 0.3, y)
        _close(total, want_total, F64)
        _grad_close(_np(ls.grad), want_grad, CG64)


def test_config4_gradient_at_the_bench_spacing_against_the_closed_form():
    """At the bench's spacing (0.05) the factors are numerically low-rank:
    their tiniest eigenvalues sit within 1e-12 of each other, where the
    eigendecomposition's backward zeroes its gauge term.  In float64 the port
    lies ~6e-7 from the closed form there (the JAX package ~5e-6); in float32
    both packages' gradients of inv_quad through the eigenvectors are wrong
    by an order of magnitude at m = 180 (ROADMAP queue 3, shared)."""
    m, h = 30, 0.05
    y = _rng(111).normal(size=(m * m, 1))
    ls = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    total, *_ = _config4_step(tlo, t_column, torch.float64, ls, _t(y), m, h)
    with tlo.settings.cg_tolerance(1e-10):
        total.backward()
    want_total, want_grad = config4_closed_form(m, h, 0.3, y)
    _close(total, want_total, F64)
    _grad_close(_np(ls.grad), want_grad, 1e-5)


def test_config4_float32_gradient_at_the_bench_spacing_is_wrong_in_both_packages():
    """Config 4 at its full size (m = 180, spacing 0.05) in float32, the same
    inputs to both packages: the step's value agrees with the float64 closed
    form to float32's rounding, but neither package's d/d(ls) does.  The
    inv_quad gradient runs through the derivative of the factors'
    eigenvectors, whose tiniest eigenvalues are float32 rounding noise; both
    packages' gradients lie more than 10 times the gradient's size from the
    closed form here (the port's moves with the BLAS thread count).  The
    defect is shared (ROADMAP queue 3); the float64 gradients are held in
    the tests above."""
    m, h = 180, 0.05
    y = _rng(111).normal(size=(m * m, 1)).astype(np.float32)
    want_total, want_grad = config4_closed_form(m, h, 0.3, y.astype(np.float64))

    def jstep(ls, y):
        return _config4_step(jlo, j_column, jnp.float32, ls, y, m, h)[0]

    jtotal, jgrad = _jit(jax.value_and_grad(jstep))(jnp.asarray(0.3, jnp.float32), _j(y, jnp.float32))
    ls = torch.tensor(0.3, dtype=torch.float32, requires_grad=True)
    total, *_ = _config4_step(tlo, t_column, torch.float32, ls, _t(y, torch.float32), m, h)
    total.backward()
    _close(total, want_total, F32)
    _close(jtotal, want_total, F32)
    off = {"port": abs(float(ls.grad) - want_grad) / abs(want_grad), "jax": abs(float(jgrad) - want_grad) / abs(want_grad)}
    assert min(off.values()) > 1.0, (want_grad, float(ls.grad), float(jgrad), off)
