"""The port's operator algebra against the JAX package on the CPU, in
float64: the repaired triangular and diagonal faults, the products, sums,
repeats and permutations of operators, ``add_low_rank`` and ``cat_rows`` on
both routes (a carried root is updated; none is computed), the sum of an
added-diagonal operator and another, the user's and the default
preconditioner.  Tolerance 1e-10 of the largest entry; 1e-6 where CG runs
(it stops at a relative residual of 1e-10 or 1e-11, which the operators'
condition numbers, 1e3 to 1e4, amplify in the solution)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from test_torch_gp_slice import _Both
from test_torch_structure import _jit
from test_torch_harness_common import close, jx, normal, positive, psd, one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_roots import same_draws  # noqa: F401  (a fixture)

CG = 1e-6


def tt(a):
    a = np.asarray(a)
    return torch.tensor(a, dtype=torch.float64) if a.dtype.kind == "f" else torch.tensor(a)


def _pair(cls_name, *arrays, **kw):
    """The same operator in both packages, from dense arrays."""
    j = getattr(jlo, cls_name)(*(jx(a) for a in arrays), **kw)
    t = getattr(tlo, cls_name)(*(tt(a) for a in arrays), **kw)
    return j, t


def _dense(a):
    return jlo.DenseLinearOperator(jx(a)), tlo.DenseLinearOperator(tt(a))


# ---------------------------------------------------------------------------
# The faults: each call answered wrongly or raised in the port before
# ---------------------------------------------------------------------------

L5 = np.tril(normal(1, 5, 5)) + 3 * np.eye(5)
D5 = positive(2, 5)
B5 = normal(3, 5, 2)


def _tri(a, upper=False):
    return (
        jlo.TriangularLinearOperator(jlo.DenseLinearOperator(jx(a)), upper=upper),
        tlo.TriangularLinearOperator(tlo.DenseLinearOperator(tt(a)), upper=upper),
    )


def test_triangular_logdet_is_log_abs_det():
    j, t = _tri(L5)
    close(t.logdet(), j.logdet())
    close(t.logdet(), np.linalg.slogdet(L5)[1])


def test_triangular_inv_quad_logdet():
    j, t = _tri(L5)
    iq_j, ld_j = j.inv_quad_logdet(jx(B5), logdet=True)
    iq_t, ld_t = t.inv_quad_logdet(tt(B5), logdet=True)
    close(iq_t, iq_j)
    close(ld_t, ld_j)
    close(iq_t, np.sum(np.linalg.solve(L5, B5) * B5))


def test_triangular_of_a_diagonal_logdet():
    j = jlo.TriangularLinearOperator(jlo.DiagLinearOperator(jx(D5)))
    t = tlo.TriangularLinearOperator(tlo.DiagLinearOperator(tt(D5)))
    close(t.logdet(), j.logdet())


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("left", [True, False])
def test_triangular_solve_triangular(upper, left):
    j, t = _tri(L5.T if upper else L5, upper=upper)
    rhs = B5 if left else B5.T
    close(t.solve_triangular(tt(rhs), upper=upper, left=left), j.solve_triangular(jx(rhs), upper=upper, left=left))
    with pytest.raises(RuntimeError):
        t.solve_triangular(tt(rhs), upper=not upper)


def _constant_pair():
    """A constant diagonal in the port, and the JAX package's Diag of the
    same diagonal: the JAX ConstantDiag's exp, log, abs and matmul apply
    Diag's to its (1,) constant and answer a 1 x 1 operator (ROADMAP queue 3,
    a fault of the JAX package alone)."""
    c = np.array([1.7])
    return jlo.DiagLinearOperator(jx(np.full(5, 1.7))), tlo.ConstantDiagLinearOperator(tt(c), diag_shape=5)


@pytest.mark.parametrize("fn", ["sqrt", "exp", "log", "abs"])
@pytest.mark.parametrize("kind", ["diag", "constant"])
def test_diag_elementwise_functions(fn, kind):
    j, t = _pair("DiagLinearOperator", D5) if kind == "diag" else _constant_pair()
    rj, rt = getattr(j, fn)(), getattr(t, fn)()
    assert type(rt) is type(t)
    close(rt.to_dense(), rj.to_dense())


def test_diag_solve_triangular():
    j, t = _pair("DiagLinearOperator", D5)
    for upper in (False, True):
        close(t.solve_triangular(tt(B5), upper=upper), j.solve_triangular(jx(B5), upper=upper))
    close(t.solve_triangular(tt(B5.T), upper=False, left=False), j.solve_triangular(jx(B5.T), upper=False, left=False))


@pytest.mark.parametrize("op", ["matmul", "mul"])
@pytest.mark.parametrize("kind", ["diag", "constant"])
def test_diag_times_diag_stays_diagonal(op, kind):
    j, t = _pair("DiagLinearOperator", D5) if kind == "diag" else _constant_pair()
    rj, rt = getattr(j, op)(j), getattr(t, op)(t)
    assert type(rt) is type(t)
    close(rt.to_dense(), rj.to_dense())


def test_diag_matmul_dense_triangular_and_block():
    jd, td = _pair("DiagLinearOperator", D5)
    a = normal(4, 5, 5)
    jo, to = _dense(a)
    r = td @ to
    assert isinstance(r, tlo.DenseLinearOperator)
    close(r.to_dense(), (jd @ jo).to_dense())
    jt, tt_ = _tri(L5)
    r = td @ tt_
    assert isinstance(r, tlo.TriangularLinearOperator)
    close(r.to_dense(), (jd @ jt).to_dense())
    blocks = psd(5, 5, n=1)
    jb = jlo.BlockDiagLinearOperator(jlo.DenseLinearOperator(jx(blocks)))
    tb = tlo.BlockDiagLinearOperator(tlo.DenseLinearOperator(tt(blocks)))
    r = td @ tb
    assert isinstance(r, tlo.BlockDiagLinearOperator)
    close(r.to_dense(), (jd @ jb).to_dense())


# ---------------------------------------------------------------------------
# Products, sums, repeats and permutations of operators
# ---------------------------------------------------------------------------


def test_operator_matmul_operator_is_lazy():
    ja, ta = _dense(normal(10, 3, 6, 4))
    jb, tb = _dense(normal(11, 4, 5))
    r = ta @ tb
    assert isinstance(r, tlo.MatmulLinearOperator)
    close(r.to_dense(), (ja @ jb).to_dense())
    rhs = normal(12, 3, 5, 2)
    close(r @ tt(rhs), (ja @ jb) @ jx(rhs))
    lhs = normal(13, 3, 2, 6)
    close(tt(lhs) @ r, jx(lhs) @ (ja @ jb).to_dense())
    close(ta.rmatmul(tt(lhs)), ja.rmatmul(jx(lhs)))


@pytest.mark.parametrize("other", ["operator", "tensor"])
def test_mul_of_an_operator_is_hadamard(other):
    a, b = psd(14, n=5), psd(15, n=5)
    ja, ta = _dense(a)
    jb, tb = _dense(b)
    with _Both(fast_computations=None) if False else _Both():
        rj = ja.mul(jb if other == "operator" else jx(b))
        rt = ta.mul(tb if other == "operator" else tt(b))
    assert isinstance(rt, tlo.MulLinearOperator)
    close(rt.to_dense(), rj.to_dense(), tol=1e-9)
    close(rt.to_dense(), a * b, tol=1e-9)


@pytest.mark.parametrize("dim", [0, 1, -3])
def test_sum_over_a_batch_dim(dim):
    a = psd(16, 2, 3, n=4)
    ja, ta = _dense(a)
    rj, rt = ja.sum(dim), ta.sum(dim)
    assert isinstance(rt, tlo.SumBatchLinearOperator)
    close(rt.to_dense(), rj.to_dense())
    close(ta.sum(), ja.sum())
    close(ta.sum(-1), ja.sum(-1))


@pytest.mark.parametrize("lazy", [False, True])
def test_prod_over_a_batch_dim(lazy):
    a = psd(17, 3, n=4)
    ja, ta = _dense(a)
    rj, rt = ja.prod(0, lazy=lazy), ta.prod(0, lazy=lazy)
    assert type(rt).__name__ == type(rj).__name__
    close(rt.to_dense(), rj.to_dense(), tol=1e-9)
    close(rt.to_dense(), np.prod(a, axis=0), tol=1e-9)


def test_repeat_permute_transpose_unsqueeze_squeeze():
    a = psd(18, 2, 3, n=4)
    ja, ta = _dense(a)
    cases = [
        lambda o: o.repeat(2, 1, 1, 1),
        lambda o: o.repeat(2, 1, 1, 1).repeat(1, 2, 1, 1),
        lambda o: o.permute(1, 0),
        lambda o: o.permute(1, 0, 2, 3),
        lambda o: o.permute(-1, 0) if False else o.permute(1, 0, -2, -1),
        lambda o: o.transpose(0, 1),
        lambda o: o.transpose(-1, -2),
        lambda o: o.unsqueeze(1),
        lambda o: o.unsqueeze(1).squeeze(1),
        lambda o: o[:1].squeeze(0),
        lambda o: o.expand(4, 2, 3, 4, 4),
        lambda o: o.reshape(-1, 2, 3, 4, 4),
    ]
    for i, fn in enumerate(cases):
        rj, rt = fn(ja), fn(ta)
        assert tuple(rt.shape) == tuple(rj.shape), i
        close(rt.to_dense(), rj.to_dense(), what=str(i))
    rep = ta.repeat(2, 1, 1, 1)
    assert isinstance(rep, tlo.BatchRepeatLinearOperator)
    rhs = normal(19, 4, 3, 4, 2)
    close(rep @ tt(rhs), ja.repeat(2, 1, 1, 1) @ jx(rhs))


def test_t_T_div_sub_trace_isclose():
    a = normal(20, 4, 4)
    ja, ta = _dense(a)
    close(ta.t().to_dense(), ja.t().to_dense())
    close(ta.T.to_dense(), ja.T.to_dense())
    close(ta.div(2.0).to_dense(), ja.div(2.0).to_dense())
    close(ta.sub(ta, alpha=0.5).to_dense(), ja.sub(ja, alpha=0.5).to_dense())
    close(ta.trace(), ja.trace())
    assert bool(torch.all(ta.isclose(tt(a)))) and bool(jnp.all(ja.isclose(jx(a))))
    with pytest.raises(RuntimeError):
        ta.div(tlo.ZeroLinearOperator((4, 4), dtype=torch.float64))


def test_permutation_helpers():
    from linear_operator_tpu.utils import permutation as jperm
    from linear_operator_tpu_torch.utils import permutation as tperm

    a = normal(22, 2, 5, 4)
    left = np.array([[3, 0, 4], [1, 1, 2]])  # a partial left permutation
    right = np.array([[2, 0, 3, 1], [3, 2, 1, 0]])
    close(tperm.apply_permutation(tt(a), tt(left), tt(right)), jperm.apply_permutation(jx(a), jx(left), jx(right)))
    close(tperm.apply_permutation(tlo.DenseLinearOperator(tt(a)), tt(left)), jperm.apply_permutation(jx(a), jx(left)))
    close(tperm.inverse_permutation(tt(right)), jperm.inverse_permutation(jx(right)))


def test_casts_move_every_tensor():
    x = normal(21, 6, 2)
    op = tlo.rbf_kernel_operator(tt(x), lengthscale=1.2, outputscale=0.7)
    op = op.add_diagonal(torch.tensor(0.1, dtype=torch.float64))
    f32 = op.float()
    assert f32.dtype == torch.float32 and all(t.dtype == torch.float32 for t in f32._leaves())
    assert f32.double().dtype == torch.float64
    assert op.type() == torch.float64 and op.type(torch.float32).dtype == torch.float32
    moved = op.to("cpu", torch.float32)
    assert moved.device.type == "cpu" and moved.dtype == torch.float32
    assert op.cpu().device.type == "cpu"
    perm = tlo.PermutationLinearOperator(torch.tensor([2, 0, 1]))
    assert perm.double().perm.dtype == torch.int64 and perm.double().dtype == torch.float64
    c = op.clone()
    assert all(a is not b for a, b in zip(c._leaves(), op._leaves()))
    close(c.to_dense(), op.to_dense())


def test_cat_batch_dim_and_module_cat():
    a, b = psd(75, 2), psd(76, 3)
    jj = jlo.operators.cat([jlo.DenseLinearOperator(jx(a)), jlo.DenseLinearOperator(jx(b))], dim=0)
    tj = tlo.cat([tlo.DenseLinearOperator(tt(a)), tlo.DenseLinearOperator(tt(b))], dim=0)
    assert tuple(tj.shape) == (5, 6, 6)
    close(tj.to_dense(), jj.to_dense())
    rhs = normal(77, 5, 6, 2)
    close(tj @ tt(rhs), jj @ jx(rhs))
    close(tj @ tt(rhs[:1]), jj @ jx(rhs[:1]))  # a broadcast rhs


def test_block_diag_of_diag_is_diag():
    d = positive(78, 3, 4)
    t = tlo.BlockDiagLinearOperator(tlo.DiagLinearOperator(tt(d)))
    assert type(t) is tlo.DiagLinearOperator
    close(t.to_dense(), jlo.BlockDiagLinearOperator(jlo.DiagLinearOperator(jx(d))).to_dense())


def test_cat_slices_route_to_blocks():
    a, b = normal(79, 3, 6), normal(80, 4, 6)
    j = jlo.CatLinearOperator((jlo.DenseLinearOperator(jx(a)), jlo.DenseLinearOperator(jx(b))), cat_dim=-2)
    t = tlo.CatLinearOperator((tlo.DenseLinearOperator(tt(a)), tlo.DenseLinearOperator(tt(b))), cat_dim=-2)
    for sl in (slice(2, 6), slice(0, 7, 2), slice(4, 7), slice(None, None, -1)):
        close(t[sl, :].to_dense(), j[sl, :].to_dense(), what=str(sl))
    assert isinstance(t[4:7, :], tlo.DenseLinearOperator)
    # the diagonal of the 7 x 6 operator has 6 entries (the JAX package's
    # reads a clamped seventh)
    close(t._diagonal(), j._diagonal()[:6])
    close(t._diagonal(), np.diagonal(np.concatenate([a, b])))


# ---------------------------------------------------------------------------
# Online updates: add_low_rank and cat_rows
# ---------------------------------------------------------------------------


def _chol_pair(K):
    L = np.linalg.cholesky(K)
    j = jlo.CholLinearOperator(jlo.TriangularLinearOperator(jlo.DenseLinearOperator(jx(L))))
    t = tlo.CholLinearOperator(tlo.TriangularLinearOperator(tlo.DenseLinearOperator(tt(L))))
    return j, t


def test_add_low_rank_updates_a_carried_root():
    K = psd(140, n=10)
    j, t = _chol_pair(K)
    v = normal(141, 10, 2)
    rj, rt = j.add_low_rank(jx(v)), t.add_low_rank(tt(v))
    assert isinstance(rt, tlo.RootLinearOperator)
    close(rt.to_dense(), rj.to_dense())
    close(rt.to_dense(), K + v @ v.T)
    b = normal(142, 10, 1)
    close(rt.solve(tt(b)), rj.solve(jx(b)), tol=1e-8)


def test_add_low_rank_without_a_root_is_a_lazy_sum(monkeypatch):
    K = psd(143, n=10)
    j, t = _dense(K)
    v = normal(144, 10, 3)

    def refuse(*args, **kwargs):
        raise AssertionError("a root was computed")

    monkeypatch.setattr(tlo.LinearOperator, "root_decomposition", refuse)
    rt = t.add_low_rank(tt(v))
    assert type(rt) is tlo.SumLinearOperator
    close(rt.to_dense(), j.add_low_rank(jx(v)).to_dense())
    appended = t.cat_rows(tt(v.T), tt(v.T @ np.linalg.solve(K, v) + np.eye(3)))
    assert not isinstance(appended, tlo.RootLinearOperator)
    # + a root operator is a low-rank update too
    close((t + tlo.RootLinearOperator(tt(v))).to_dense(), (j + jlo.RootLinearOperator(jx(v))).to_dense())


def test_cat_rows_root_route():
    n, m = 12, 3
    K = psd(145, n=n + m)
    j, t = _chol_pair(K[:n, :n])
    rt = t.cat_rows(tt(K[n:, :n]), tt(K[n:, n:]))
    assert isinstance(rt, tlo.RootLinearOperator)
    b = normal(146, n + m, 1)

    def reference(op, cross, new, rhs):
        joined = op.cat_rows(cross, new)
        return joined.root.to_dense(), joined.solve(rhs), joined.logdet()

    root_j, x_j, ld_j = _jit(reference)(j, jx(K[n:, :n]), jx(K[n:, n:]), jx(b))
    close(rt.root.to_dense(), root_j, tol=1e-9)
    close(rt.to_dense(), K, tol=1e-9)
    close(rt.solve(tt(b)), x_j, tol=1e-8)
    close(rt.logdet(), ld_j, tol=1e-8)


def test_cat_rows_lazy_route():
    n, m = 8, 2
    K = psd(147, n=n + m)
    j, t = _dense(K[:n, :n])
    rj = j.cat_rows(jx(K[n:, :n]), jx(K[n:, n:]), generate_roots=False)
    rt = t.cat_rows(tt(K[n:, :n]), tt(K[n:, n:]), generate_roots=False)
    assert isinstance(rt, tlo.CatLinearOperator) and all(isinstance(o, tlo.CatLinearOperator) for o in rt.operators)
    close(rt.to_dense(), K, tol=1e-12)
    rhs = normal(148, n + m, 2)
    close(rt @ tt(rhs), rj @ jx(rhs))
    with _Both(max_cholesky_size=0, cg_tolerance=1e-10, max_cg_iterations=200):
        close(rt.solve(tt(rhs)), rj.solve(jx(rhs)), tol=CG)


def test_cat_rows_batched_diagonal_and_trace():
    """cat_rows of a batched operator (a Cat of Cats whose blocks are
    batched, as a batched fantasy model makes): every stretch of the
    diagonal is read, not only the first block's."""
    n, m = 6, 3
    K = psd(149, 2, n=n + m)
    j, t = _dense(K[..., :n, :n])
    cross, new = K[..., n:, :n], K[..., n:, n:]
    rt = t.cat_rows(tt(cross), tt(new), generate_roots=False)
    assert isinstance(rt, tlo.CatLinearOperator) and tuple(rt.shape) == (2, n + m, n + m)
    # blocks of unequal heights stacked by rows: the diagonal of the 4 x 4
    # batched operator has 4 entries
    a, b = normal(150, 2, 3, 4), normal(151, 2, 1, 4)
    tc = tlo.CatLinearOperator((tlo.DenseLinearOperator(tt(a)), tlo.DenseLinearOperator(tt(b))), cat_dim=-2)
    jc = jlo.CatLinearOperator((jlo.DenseLinearOperator(jx(a)), jlo.DenseLinearOperator(jx(b))), cat_dim=-2)

    def reference(op, cross, new, stacked):
        joined = op.cat_rows(cross, new, generate_roots=False)
        return joined.diagonal(), joined.trace(), stacked.diagonal(), stacked.trace()

    diag_j, trace_j, diag_cj, trace_cj = _jit(reference)(j, jx(cross), jx(new), jc)
    close(rt.diagonal(), diag_j)
    close(rt.diagonal(), np.diagonal(K, axis1=-2, axis2=-1))
    close(rt.trace(), trace_j)
    close(tc.diagonal(), diag_cj)
    close(tc.trace(), trace_cj)


# ---------------------------------------------------------------------------
# (K + D) + K2 and the preconditioners
# ---------------------------------------------------------------------------

N_PRE = 64
PRE = dict(max_cholesky_size=0, min_preconditioning_size=50, max_preconditioner_size=6, cg_tolerance=1e-10,
           max_cg_iterations=400, num_trace_samples=6)


def _kernel_pair(seed, n=N_PRE):
    x = normal(seed, n, 2)
    return (
        jlo.operators.kernel.rbf_kernel_operator(jx(x), lengthscale=jnp.asarray(0.7), outputscale=jnp.asarray(1.1)),
        tlo.rbf_kernel_operator(tt(x), lengthscale=0.7, outputscale=1.1, use_fused_kernels=False),
    )


def test_added_diag_plus_an_operator_stays_preconditioned(same_draws):
    jk, tk = _kernel_pair(150)
    jk2, tk2 = _dense(0.1 * psd(151, n=N_PRE) / N_PRE)
    d = positive(152, N_PRE, shift=0.05) * 0.1
    rj = (jk.add_diagonal(jx(d))) + jk2
    rt = (tk.add_diagonal(tt(d))) + tk2
    assert type(rt) is tlo.AddedDiagLinearOperator and type(rj).__name__ == "AddedDiagLinearOperator"
    close(rt.to_dense(), rj.to_dense())
    y = normal(153, N_PRE, 1)
    with _Both(**PRE):
        assert rt._preconditioner()[0] is not None
        iq_j, ld_j = _jit(lambda op, rhs: op.inv_quad_logdet(rhs, logdet=True))(rj, jx(y))
        iq_t, ld_t = rt.inv_quad_logdet(tt(y), logdet=True, generator=torch.Generator().manual_seed(0))
    close(iq_t, iq_j, tol=CG)
    close(ld_t, ld_j, tol=CG)


def test_preconditioner_override():
    jk, tk = _kernel_pair(154, n=40)
    d = np.full(40, 0.3)
    calls = []

    def override(op):
        calls.append(op)
        diag = op._diag_op._diagonal()
        return (lambda v: v / diag[..., :, None]), None, torch.sum(torch.log(diag), dim=-1)

    t = tlo.AddedDiagLinearOperator(tk, tlo.DiagLinearOperator(tt(d)), preconditioner_override=override)
    j = jlo.AddedDiagLinearOperator(jk, jlo.DiagLinearOperator(jx(d)))
    y = normal(155, 40, 2)
    with _Both(max_cholesky_size=0, cg_tolerance=1e-11, max_cg_iterations=400, min_preconditioning_size=10**6):
        xt = t.solve(tt(y))
        xj = _jit(lambda op, rhs: op.solve(rhs))(j, jx(y))
    assert calls, "the override was not consulted"
    close(xt, xj, tol=CG)


def test_default_preconditioner(same_draws):
    """The rangefinder preconditioner matches the JAX package's on the same
    sketch.  Its root's columns carry the signs of each package's
    eigenvectors, so the probes it draws differ: the two SLQ log-determinants
    are held to the true one (and to each other) at 128 probes, not at the
    CG tolerance."""
    a = psd(156, n=N_PRE) / N_PRE + 0.5 * np.eye(N_PRE)
    j, t = _dense(a)
    y = normal(157, N_PRE, 1)
    assert t._preconditioner()[0] is None
    with _Both(**PRE), tlo.beta_features.default_preconditioner(), jlo.beta_features.default_preconditioner():
        ct, pt, ldt = t._preconditioner()
        assert ct is not None

        def reference(op, rhs):
            closure, precond, logdet = op._preconditioner()
            return logdet, precond.to_dense(), closure(rhs)

        ldj, pj, cj_y = _jit(reference)(j, jx(y))
        close(ldt, ldj, tol=1e-9)
        close(pt.to_dense(), pj, tol=1e-9)
        close(ct(tt(y)), cj_y, tol=1e-9)
        with _Both(num_trace_samples=128):
            iq_j, ld_j = _jit(lambda op, rhs: op.inv_quad_logdet(rhs, logdet=True))(j, jx(y))
            iq_t, ld_t = t.inv_quad_logdet(tt(y), logdet=True, generator=torch.Generator().manual_seed(0))
    close(iq_t, iq_j, tol=CG)
    true = np.linalg.slogdet(a)[1]
    assert abs(float(ld_t) - true) < 0.02 * abs(true) and abs(float(ld_j) - true) < 0.02 * abs(true)
    assert abs(float(ld_t) - float(ld_j)) < 0.02 * abs(true)
