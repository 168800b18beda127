"""The port's interpolation layer and SKI / KISS-GP model against the JAX
package: ``utils/sparse.py`` (gather, scatter-add, flattened grid
stencils), the interpolated and grid-interpolated operators, and
``SKIGPRegression``
(interpolation stencils, covariance, ``neg_mll`` and its gradients under the
JAX bench's settings and under the default pivoted preconditioner,
``posterior_mean``, the LOVE ``posterior``), with the weights and the grid
carried across from the JAX package's arrays.

Seeded numpy inputs go to both packages; the JAX references are jitted, and
``same_draws`` gives both packages the same probes and start vectors.  The
JAX package applies grid stencils by one-hot panel products wherever its
panels fit (its route for a TPU) and by gather and scatter-add otherwise;
the port always takes the gather and scatter-add, and is held against the
JAX package on both of its routes.  Tolerances, relative to the largest
entry (gradients: to their norm): 1e-8 for the mat-vecs and closed forms in
float64, 1e-7 where CG or SLQ runs, 1e-4 in float32.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.models import ski as jski
from linear_operator_tpu.utils import grid_interp as jgi
from linear_operator_tpu.utils import sparse as jsp
from linear_operator_tpu_torch.models import ski as tski
from linear_operator_tpu_torch.operators import GridInterpolatedLinearOperator, LinearOperator
from linear_operator_tpu_torch.utils import sparse as tsp
from test_torch_gp_slice import _Both, _close, _grad_close, _np
from test_torch_structure import _jit
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

F64 = 1e-8
CG64 = 1e-7
F32 = 1e-4
RAW = ("raw_lengthscale", "raw_outputscale", "raw_noise")
# the JAX bench's settings for config 4b (bench.py:278-298)
BENCH = dict(
    max_cholesky_size=0,
    num_trace_samples=10,
    max_cg_iterations=100,
    cg_tolerance=1.0,
    min_preconditioning_size=10**9,
    max_lanczos_quadrature_iterations=20,
)
# the defaults, with CG in place of Cholesky and the rank-15 pivoted
# preconditioner switched on at this n
DEFAULTS = dict(max_cholesky_size=0, min_preconditioning_size=100)


def _rng(seed):
    return np.random.default_rng(seed)


def _draw(shape):
    """One fixed normal array for each shape, whatever the order of the
    requests (so that a JAX reference traced in one test serves another)."""
    return np.random.default_rng(zlib.crc32(repr(tuple(int(s) for s in shape)).encode())).normal(size=shape)


@pytest.fixture
def same_draws(monkeypatch):
    """Both packages' normal draws (``jax.random.normal`` and ``torch.randn``)
    return ``_draw(shape)``."""

    def jax_draw(key, shape=(), dtype=jnp.float64):
        return jnp.asarray(_draw(shape), dtype=dtype)

    def torch_draw(*size, dtype=None, device=None, generator=None):
        shape = size[0] if len(size) == 1 and not isinstance(size[0], int) else size
        return torch.from_numpy(_draw(shape)).to(dtype=dtype or torch.get_default_dtype(), device=device)

    monkeypatch.setattr(jax.random, "normal", jax_draw)
    monkeypatch.setattr(torch, "randn", torch_draw)


_JAX_NEG_MLL = {}
JAX_ROUTES = ["onehot", "flat"]


def _jax_route(monkeypatch, route):
    """The JAX package's grid-interpolated operator on ``route``: its one-hot
    panels (its default wherever they fit) or its flat gather and scatter."""
    if route == "flat":
        monkeypatch.setattr(jlo.operators.GridInterpolatedLinearOperator, "_use_onehot", lambda self, t: False)


def _jax_neg_mll(interp, settings, monkeypatch, route="onehot", dtype=np.float64):
    """The JAX model's neg_mll and gradient under ``settings`` on ``route``
    (traced once for each; call under ``same_draws``)."""
    key = (interp, tuple(sorted(settings.items())), route, dtype)
    if key not in _JAX_NEG_MLL:
        x, y, _ = (a.astype(dtype) for a in _ski_data())
        jmodel, params, _ = _ski_models(interp, dtype)
        with monkeypatch.context() as patch, _Both(**settings):
            _jax_route(patch, route)
            value, grad = _jit(jax.value_and_grad(
                lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y), key=jax.random.PRNGKey(1))))(params)
        _JAX_NEG_MLL[key] = (np.asarray(value), np.concatenate([np.ravel(getattr(grad, name)) for name in RAW]))
    return _JAX_NEG_MLL[key]


def _t(a, dtype=torch.float64):
    a = np.asarray(a)
    return torch.tensor(a, dtype=dtype) if a.dtype.kind == "f" else torch.tensor(a, dtype=torch.int64)


def _j(a, dtype=jnp.float64):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=dtype) if a.dtype.kind == "f" else jnp.asarray(a, dtype=jnp.int32)


def _stencils(seed, sizes, n, k=2):
    rng = _rng(seed)
    idx = tuple(rng.integers(0, m, size=(n, k)) for m in sizes)
    val = tuple(rng.normal(size=(n, k)) for _ in sizes)
    return idx, val


def _spd(seed, n):
    a = _rng(seed).normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


# ---------------------------------------------------------------------------
# utils/sparse.py and the interpolated operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [(), (2,)])
def test_sparse_interp_matches_jax(batch):
    rng = _rng(1)
    n, k, M, t = 9, 3, 7, 4
    idx = rng.integers(0, M, size=(*batch, n, k))
    idx[..., 0, :] = 2  # a row whose entries all land on one grid point
    val = rng.normal(size=(*batch, n, k))
    grid_v, pt_v = rng.normal(size=(*batch, M, t)), rng.normal(size=(2, *batch, n, t))
    want = _jit(lambda i, v, g, p: (jsp.left_interp(i, v, g), jsp.left_t_interp(i, v, p, M)))(
        _j(idx), _j(val), _j(grid_v), _j(pt_v)
    )
    got = (tsp.left_interp(_t(idx), _t(val), _t(grid_v)), tsp.left_t_interp(_t(idx), _t(val), _t(pt_v), M))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, F64)
    matrix = tlo.operators.InterpolationMatrix(_t(idx), _t(val), M)
    _close(tsp.bdsmm(matrix, _t(grid_v)), want[0], F64)
    _close(tsp.bdsmm(_t(np.eye(M)[:4]), _t(grid_v)), np.eye(M)[:4] @ grid_v, F64)


def _interp_pair(batch=(), seed=2):
    rng = _rng(seed)
    M, n_l, n_r, k = 10, 6, 5, 2
    base = _spd(seed, M) if not batch else np.stack([_spd(seed + i, M) for i in range(batch[0])])
    li, ri = rng.integers(0, M, size=(*batch, n_l, k)), rng.integers(0, M, size=(*batch, n_r, k))
    lv, rv = rng.uniform(size=(*batch, n_l, k)), rng.uniform(size=(*batch, n_r, k))
    arrays = (base, li, lv, ri, rv)
    jop = jlo.operators.InterpolatedLinearOperator(jlo.operators.DenseLinearOperator(_j(base)), *map(_j, arrays[1:]))
    top = tlo.operators.InterpolatedLinearOperator(tlo.operators.DenseLinearOperator(_t(base)), *map(_t, arrays[1:]))
    return jop, top, arrays


@pytest.mark.parametrize("batch", [(), (2,)])
def test_interpolated_operator_matches_jax(batch):
    jop, top, (base, li, lv, ri, rv) = _interp_pair(batch)
    rng = _rng(3)
    rhs, lhs = rng.normal(size=(*batch, 5, 3)), rng.normal(size=(*batch, 6, 2))
    rows, cols = rng.integers(0, 6, size=7), rng.integers(0, 5, size=7)
    bidx = [rng.integers(0, b, size=7) for b in batch]

    every = [slice(None)] * len(batch)  # a batched operator's indices name its batch dims

    def ref(op, rhs, lhs, rows, cols, *bidx):
        return dict(mm=op @ rhs, tmm=op._t_matmul(lhs), dense=op.to_dense(), t=op.mT.to_dense(),
                    gi=op._get_indices(rows, cols, *bidx), sub=op._getitem(slice(1, 5), slice(0, 4), *every).to_dense(),
                    pick=op._getitem(rows[:3], slice(None), *every).to_dense())

    want = _jit(ref)(jop, _j(rhs), _j(lhs), _j(rows), _j(cols), *map(_j, bidx))
    got = ref(top, _t(rhs), _t(lhs), _t(rows), _t(cols), *map(_t, bidx))
    for key in want:
        _close(got[key], want[key], F64)
    wl = np.zeros((*batch, 6, 10))
    wr = np.zeros((*batch, 5, 10))
    for b in np.ndindex(*batch):
        np.add.at(wl[b], (np.arange(6)[:, None], li[b]), lv[b])
        np.add.at(wr[b], (np.arange(5)[:, None], ri[b]), rv[b])
    _close(got["dense"], wl @ base @ np.swapaxes(wr, -1, -2), F64)
    if batch:
        sub = top._getitem(slice(0, 3), slice(1, 4), 1)
        _close(sub.to_dense(), jop._getitem(slice(0, 3), slice(1, 4), 1).to_dense(), F64)
    # a square one: its diagonal, by pointwise reads of the base
    sq_j = jlo.operators.InterpolatedLinearOperator(jop.base, jop.left_indices, jop.left_values, jop.left_indices, jop.left_values)
    sq_t = tlo.operators.InterpolatedLinearOperator(top.base, top.left_indices, top.left_values, top.left_indices, top.left_values)
    _close(sq_t.diagonal(), _jit(lambda o: o.diagonal())(sq_j), F64)


def test_interpolated_operator_gradients_match_jax():
    jop, top, (base, li, lv, ri, rv) = _interp_pair()
    rhs = _rng(4).normal(size=(5, 2))

    def jloss(base, lv, rv):
        op = jlo.operators.InterpolatedLinearOperator(jlo.operators.DenseLinearOperator(base), _j(li), lv, _j(ri), rv)
        return jnp.sum((op @ _j(rhs)) ** 2)

    want = _jit(jax.grad(jloss, argnums=(0, 1, 2)))(_j(base), _j(lv), _j(rv))
    tb, tl, tr = (_t(a).requires_grad_(True) for a in (base, lv, rv))
    op = tlo.operators.InterpolatedLinearOperator(tlo.operators.DenseLinearOperator(tb), _t(li), tl, _t(ri), tr)
    torch.sum((op @ _t(rhs)) ** 2).backward()
    for g, w in zip((tb, tl, tr), want):
        _grad_close(_np(g.grad), w, F64)
    # the index tensors ride along as leaves without a gradient
    grads = op._bilinear_derivative(_t(_rng(5).normal(size=(6, 2))), _t(rhs))
    assert len(grads) == len(list(op._leaves())) and grads[1] is None and grads[3] is None


# ---------------------------------------------------------------------------
# flattened grid stencils and the grid-interpolated operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(7,), (6, 5), (4, 3, 5)])
@pytest.mark.parametrize("block", [None, 256])
def test_flat_grid_stencils_match_the_jax_one_hot_engine(sizes, block):
    """The port's flattened stencils, applied by gather and scatter-add, give
    the JAX package's one-hot panel products (at its default block and at
    one of 256 rows)."""
    n, t, M = 37, 3, int(np.prod(sizes))
    idx, val = _stencils(sum(sizes), sizes, n)
    rng = _rng(6)
    g, v = rng.normal(size=(M, t)), rng.normal(size=(n, t))

    @_jit
    def ref(idx, val, g, v):
        fi, fv = jgi.flatten_grid_interp(idx, val, sizes)
        return dict(mm=jgi.grid_matmul(idx, val, g, sizes, block=block), tmm=jgi.grid_t_matmul(idx, val, v, sizes, block=block),
                    fi=fi, fv=fv)

    want = ref(tuple(map(_j, idx)), tuple(map(_j, val)), _j(g), _j(v))
    fi, fv = tsp.flatten_grid_interp(tuple(map(_t, idx)), tuple(map(_t, val)), sizes)
    got = dict(mm=tsp.left_interp(fi, fv, _t(g)), tmm=tsp.left_t_interp(fi, fv, _t(v), M), fi=fi, fv=fv)
    for key in want:
        _close(got[key], want[key], F64)


def test_grid_interpolated_gradients_match_jax():
    """Gradients reach the per-dimension stencil values through the
    flattening, as they reach them through the JAX one-hot panels."""
    sizes, n = (6, 5), 11
    idx, val = _stencils(7, sizes, n)
    g = _rng(8).normal(size=(30, 2))
    base = _spd(8, 30)
    want = _jit(jax.grad(lambda val: jnp.sum(jgi.grid_matmul(tuple(map(_j, idx)), val, _j(g), sizes) ** 2)))(
        tuple(map(_j, val))
    )
    tv = tuple(_t(v).requires_grad_(True) for v in val)
    ti = tuple(map(_t, idx))
    op = GridInterpolatedLinearOperator(tlo.operators.DenseLinearOperator(_t(base)), ti, tv, ti, tv, sizes)
    torch.sum(op._left.matmul(_t(g)) ** 2).backward()
    for a, b in zip(tv, want):
        _grad_close(_np(a.grad), b, F64)


def _grid_pair(sizes=(6, 5), n_l=13, n_r=9, seed=9):
    M = int(np.prod(sizes))
    li, lv = _stencils(seed, sizes, n_l)
    ri, rv = _stencils(seed + 1, sizes, n_r)
    base = _spd(seed, M)
    jop = jlo.operators.GridInterpolatedLinearOperator(
        jlo.operators.DenseLinearOperator(_j(base)), *(tuple(map(_j, a)) for a in (li, lv, ri, rv)), sizes
    )
    top = GridInterpolatedLinearOperator(
        tlo.operators.DenseLinearOperator(_t(base)), *(tuple(map(_t, a)) for a in (li, lv, ri, rv)), sizes
    )
    return jop, top


@pytest.mark.parametrize("t", [1, 11])
def test_grid_interpolated_routes_match_jax(t, monkeypatch):
    """The port's operator against the JAX package's on each of its routes."""
    jop, top = _grid_pair()
    rng = _rng(10)
    rhs, lhs, batched = rng.normal(size=(9, t)), rng.normal(size=(13, t)), rng.normal(size=(2, 3, 9, t))
    assert jop._use_onehot(t)
    got = dict(mm=top._matmul(_t(rhs)), tmm=top._t_matmul(_t(lhs)), batched=top._matmul(_t(batched)), dense=top.to_dense())
    for route in JAX_ROUTES:
        with monkeypatch.context() as patch:
            _jax_route(patch, route)

            @_jit
            def ref(op, rhs, lhs, batched):
                return dict(mm=op._matmul(rhs), tmm=op._t_matmul(lhs), batched=op._matmul(batched), dense=op.to_dense())

            want = ref(jop, _j(rhs), _j(lhs), _j(batched))
        for key in want:
            _close(got[key], want[key], F64)


def test_grid_interpolated_indexing_matches_jax():
    jop, top = _grid_pair(n_l=9, n_r=9)
    rows, cols = _rng(11).integers(0, 9, size=(2, 6))

    @_jit
    def ref(op, rows, cols):
        return dict(gi=op._get_indices(rows, cols), diag=op.diagonal(), sub=op._getitem(slice(2, 8), slice(0, 5)).to_dense(),
                    t=op.mT.to_dense())

    want = ref(jop, _j(rows), _j(cols))
    sub = top._getitem(slice(2, 8), slice(0, 5))
    got = dict(gi=top._get_indices(_t(rows), _t(cols)), diag=top.diagonal(), sub=sub.to_dense(), t=top.mT.to_dense())
    for key in want:
        _close(got[key], want[key], F64)
    with pytest.raises(ValueError):
        GridInterpolatedLinearOperator(top.base, top.left_indices, top.left_values, top.right_indices, top.right_values, (5, 5))


# ---------------------------------------------------------------------------
# models/ski.py
# ---------------------------------------------------------------------------


def _ski_data(n=400, seed=12, m=64):
    rng = _rng(seed)
    x = rng.uniform(size=(n, 2))
    x[:4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]]  # at the edges: cubic stencils clamp there
    y = np.sin(6.0 * x[:, 0]) * np.cos(4.0 * x[:, 1]) + 0.05 * rng.normal(size=n)
    x_star = rng.uniform(size=(m, 2))
    return x, y, x_star


def _ski_models(interp, dtype=np.float64, sizes=(12, 12), raw_noise=-2.5):
    """A JAX model and its parameters, and a port model with the JAX grid and
    parameters carried across."""
    jdt, tdt = (jnp.float64, torch.float64) if dtype == np.float64 else (jnp.float32, torch.float32)
    x, _, _ = _ski_data()
    jgrid = jski.make_grid(jnp.asarray(x, jdt), sizes)
    jmodel = jski.SKIGPRegression(jgrid, interp=interp)
    # lengthscales of about one grid step: with longer ones W K W^T is
    # numerically of low rank, and CG's iterates amplify summation-order
    # differences ~1000x every two iterations (1e-5 apart after the bench's
    # 10-20 iterations, in either package against itself)
    params = jmodel.init_params(2, dtype=jdt)._replace(
        raw_lengthscale=jnp.asarray([-2.0, -2.3], jdt), raw_noise=jnp.asarray(raw_noise, jdt)
    )
    tmodel = tlo.SKIGPRegression(tlo.load_jax_grid(jgrid), interp=interp, dtype=tdt, device="cpu")
    tlo.load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _port_grads(model):
    return [_np(getattr(model, name).grad) for name in RAW]


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_ski_stencils_and_covariance_match_jax(interp):
    x, _, x_star = _ski_data()
    jmodel, params, tmodel = _ski_models(interp)
    _close(tmodel.grid.mins, jmodel.grid.mins, F64)
    jw = _jit(jmodel._interp_weights_per_dim)(jnp.asarray(x))
    tw = tmodel._interp_weights_per_dim(torch.tensor(x))
    for a, b in zip((*tw[0], *tw[1]), (*jw[0], *jw[1])):
        _close(a, b, F64)
    if interp == "cubic":
        assert any((i[:, None, :] == i[:, :, None]).sum() > 4 * i.shape[0] for i in map(_np, tw[0])), "repeated indices"
        _close(sum(np.sum(_np(w), axis=-1) for w in tw[1]) / 2, np.ones(len(x)), F64)
    else:
        fi, fv = tski.linear_interp_weights(torch.tensor(x), tmodel.grid)
        jfi, jfv = _jit(lambda xx: jski.linear_interp_weights(xx, jmodel.grid))(jnp.asarray(x))
        _close(fi, jfi, 0)
        _close(fv, jfv, F64)

    @_jit
    def ref(params, x, x_star):
        k = jmodel.covariance(params, x_star, x)
        return dict(cross=k.to_dense(), diag=jmodel.covariance(params, x_star).diagonal(),
                    train=jmodel.train_operator(params, x).to_dense(),
                    grid=jmodel.grid_operator(params).to_dense())

    want = ref(params, jnp.asarray(x), jnp.asarray(x_star))
    cross = tmodel.covariance(torch.tensor(x_star), torch.tensor(x))
    assert isinstance(cross, GridInterpolatedLinearOperator)
    got = dict(cross=cross.to_dense(), diag=tmodel.covariance(torch.tensor(x_star)).diagonal(),
               train=tmodel.train_operator(torch.tensor(x)).to_dense(), grid=tmodel.grid_operator().to_dense())
    for key in want:
        _close(got[key], want[key], F64)
    column = tski.rbf_toeplitz_column(12, 0.1, torch.tensor(0.3, dtype=torch.float64), dtype=torch.float64)
    _close(column, jski.rbf_toeplitz_column(12, 0.1, 0.3, dtype=jnp.float64), F64)


@pytest.mark.parametrize("route", JAX_ROUTES)
@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_ski_neg_mll_under_the_bench_settings_matches_jax(interp, route, same_draws, monkeypatch):
    """The port against the JAX package on each of its interpolation routes."""
    x, y, _ = _ski_data()
    want, jg = _jax_neg_mll(interp, BENCH, monkeypatch, route)
    _, _, tmodel = _ski_models(interp)
    with _Both(**BENCH):
        loss = tmodel.neg_mll(torch.tensor(x), torch.tensor(y), generator=torch.Generator().manual_seed(1))
        loss.backward()
    _close(loss, want, CG64)
    _grad_close(np.concatenate([np.ravel(g) for g in _port_grads(tmodel)]), jg, CG64)


@pytest.mark.parametrize("route", JAX_ROUTES)
def test_ski_neg_mll_with_the_pivoted_preconditioner_matches_jax(route, same_draws, monkeypatch):
    """The rank-15 pivoted Cholesky of W K W^T reads the operator through the
    structured chain (interpolated -> Kronecker -> Toeplitz ``_get_indices``),
    never the base class's dense fallback; the JAX package on each of its
    interpolation routes."""
    x, y, _ = _ski_data()
    want, jg = _jax_neg_mll("linear", DEFAULTS, monkeypatch, route)
    _, _, tmodel = _ski_models("linear")

    def dense_fallback(self, *args):
        raise AssertionError(f"{type(self).__name__} densified in _get_indices")

    monkeypatch.setattr(LinearOperator, "_get_indices", dense_fallback)
    with _Both(**DEFAULTS):
        K = tmodel.train_operator(torch.tensor(x))
        assert K.detach()._preconditioner()[0] is not None
        loss = tmodel.neg_mll(torch.tensor(x), torch.tensor(y), generator=torch.Generator().manual_seed(1))
        loss.backward()
    _close(loss, want, CG64)
    _grad_close(np.concatenate([np.ravel(g) for g in _port_grads(tmodel)]), jg, CG64)


def test_ski_float32_neg_mll_matches_jax(same_draws):
    """At noise 0.69: at 0.08 the f32 gradient after CG's 20 iterations moves
    ~1e-3 with the summation order alone (JAX against itself compiled
    otherwise), at 0.69 ~1e-6."""
    x, y, x_star = _ski_data()
    jmodel, params, tmodel = _ski_models("linear", np.float32, raw_noise=0.0)
    x32, y32, xs32 = (a.astype(np.float32) for a in (x, y, x_star))
    with _Both(**BENCH):
        (want, jg), jmean = _jit(lambda p: (
            jax.value_and_grad(lambda q: jmodel.neg_mll(q, jnp.asarray(x32), jnp.asarray(y32), key=jax.random.PRNGKey(1)))(p),
            jmodel.posterior_mean(p, jnp.asarray(x32), jnp.asarray(y32), jnp.asarray(xs32)),
        ))(params)
        loss = tmodel.neg_mll(torch.tensor(x32), torch.tensor(y32), generator=torch.Generator().manual_seed(1))
        loss.backward()
        with torch.no_grad():
            mean = tmodel.posterior_mean(torch.tensor(x32), torch.tensor(y32), torch.tensor(xs32))
    assert loss.dtype == torch.float32
    _close(loss, want, F32)
    _grad_close(np.concatenate([np.ravel(g) for g in _port_grads(tmodel)]),
                np.concatenate([np.ravel(getattr(jg, name)) for name in RAW]), F32)
    _close(mean, jmean, F32)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_ski_posterior_matches_jax(interp, same_draws):
    """``posterior_mean`` (one CG solve) and the LOVE ``posterior`` (a
    Lanczos inverse root from the same start), CG to 1e-10."""
    x, y, x_star = _ski_data()
    jmodel, params, tmodel = _ski_models(interp)
    settings = dict(max_cholesky_size=0, cg_tolerance=1e-10, max_root_decomposition_size=40)
    with _Both(**settings):
        jx, jy, jxs = (jnp.asarray(a) for a in (x, y, x_star))
        jmean, jlove = _jit(lambda p: (
            jmodel.posterior_mean(p, jx, jy, jxs), jmodel.posterior(p, jx, jy, jxs, key=jax.random.PRNGKey(2))
        ))(params)
        with torch.no_grad():
            tx, ty, txs = (torch.tensor(a) for a in (x, y, x_star))
            mean = tmodel.posterior_mean(tx, ty, txs)
            love_mean, love_var = tmodel.posterior(tx, ty, txs, generator=torch.Generator().manual_seed(2))
    _close(mean, jmean, CG64)
    _close(love_mean, jlove[0], CG64)
    _close(love_var, jlove[1], CG64)
    # the mean against a dense solve of the same covariance
    K = _np(tmodel.train_operator(torch.tensor(x)).to_dense())
    ks = _np(tmodel.covariance(torch.tensor(x_star), torch.tensor(x)).to_dense())
    _close(mean, ks @ np.linalg.solve(K, y), CG64)


def test_ski_weights_carried_across_and_device_default():
    jmodel, params, tmodel = _ski_models("cubic")
    for name in RAW:
        _close(getattr(tmodel, name).detach(), getattr(params, name), 0)
    assert tmodel.raw_lengthscale.shape == (2,) and tmodel.grid.sizes == (12, 12)
    assert isinstance(tlo.SKIParams(*params), tlo.SKIParams)
    with pytest.raises(ValueError):
        tlo.SKIGPRegression(tmodel.grid, interp="quintic", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlo.SKIGPRegression(tmodel.grid)
    # a grid too fine for the JAX package's one-hot panels (it takes flat
    # stencils there): the port's operator is the same
    x3 = _rng(13).uniform(size=(40, 3))
    jgrid = jski.make_grid(jnp.asarray(x3), (64, 64, 64))
    fine = tlo.SKIGPRegression(tlo.load_jax_grid(jgrid), device="cpu", dtype=torch.float64)
    op = fine.covariance(torch.tensor(x3))
    assert isinstance(op, GridInterpolatedLinearOperator) and op.left_indices.shape == (40, 8)
    rhs = _rng(14).normal(size=(40, 2))
    jfine = jski.SKIGPRegression(jgrid)
    jparams = jfine.init_params(3, dtype=jnp.float64)
    want = _jit(lambda p: jfine.covariance(p, jnp.asarray(x3)) @ jnp.asarray(rhs))(jparams)
    _close(op @ torch.tensor(rhs), want, F64)
