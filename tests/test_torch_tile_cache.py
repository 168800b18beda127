"""The bf16 tile cache of the port (K4 ``rbf_build_sym_tiles``, K5
``rbf_matvec_sym_cached`` and the closure builder ``rbf_fused_closure``)
against the JAX package.

The JAX package's K4 and K5 need the TPU (``pltpu``) and cannot run here, so
the ground truths are built from its own functions: ``TILE_COVARS[c][0]`` of
``_tile_sq_dist`` on the tile pairs of ``_triangle_maps``, rounded to bf16,
and the hi / lo bf16 split of v multiplied at ``Precision.HIGHEST``.

Tolerances.  K4's entries: at most one bf16 ulp each, and at least 99.9%
bit-identical (the exp of XLA and of PyTorch may differ by an f32 ulp, which
now and then crosses a bf16 rounding boundary).  K5: rtol 1e-5 of the largest
entry (f32 sums in another order, of exact bf16 x bf16 products).  The whole
slice (inv_quad_logdet, its gradient, and solve on the cached operator) runs
in f32 against the JAX package with a test-side closure builder computing the
same two-pass dense-bf16 product, at rtol 1e-4 on identical probes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.operators import kernel as jkernel
from linear_operator_tpu.operators.low_rank_root_added_diag import (
    LowRankRootAddedDiagLinearOperator as JaxLowRank,
)
from linear_operator_tpu.ops import rbf as jrbf
from linear_operator_tpu_torch.operators import kernel as tkernel
from linear_operator_tpu_torch.operators.low_rank_root_added_diag import (
    LowRankRootAddedDiagLinearOperator as TorchLowRank,
)
from linear_operator_tpu_torch.ops import rbf as trbf
from test_torch_harness_common import _jit, one_torch_thread  # noqa: F401 (an autouse fixture)

COVARS = ["rbf", "matern52", "matern32", "matern12", "rq"]


def _np(a):
    return a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _f32(value):
    # explicit: other test files change torch's default dtype when imported
    return torch.tensor(value, dtype=torch.float32)


def _names(covar):
    """The covariance's key in the JAX package and in the port."""
    if covar == "rq":
        return jrbf.rq_tile_covar(1.5), trbf.rq_tile_covar(1.5)
    return covar, covar


def _points(seed, n, d):
    return (np.random.default_rng(seed).normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)


def _jax_tiles(x, tile, covar):
    """Ground-truth K4: the JAX package's tile functions on its triangle maps,
    as uint16 bf16 bit patterns (npairs, tile, tile)."""
    n, d = x.shape
    nblk = -(-n // tile)
    xp = np.zeros((nblk * tile, d), np.float32)
    xp[:n] = x
    xp = jnp.asarray(xp)
    fn = jrbf.TILE_COVARS[covar][0]
    im, jm = (np.asarray(m) for m in jrbf._triangle_maps(nblk))
    tiles = [
        fn(jrbf._tile_sq_dist(xp[i * tile : (i + 1) * tile], xp[j * tile : (j + 1) * tile], d)).astype(jnp.bfloat16)
        for i, j in zip(im, jm)
    ]
    return np.stack([np.asarray(t).view(np.uint16) for t in tiles])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _dense_from_tiles(bits, n, tile):
    """The npad x npad f32 matrix the stored triangle stands for."""
    npairs = bits.shape[0]
    nblk = int(round((np.sqrt(8 * npairs + 1) - 1) / 2))
    vals = (bits.astype(np.uint32) << 16).view(np.float32)
    k = np.zeros((nblk * tile, nblk * tile), np.float32)
    for s, (i, j) in enumerate(zip(*np.triu_indices(nblk))):
        k[i * tile : (i + 1) * tile, j * tile : (j + 1) * tile] = vals[s]
        k[j * tile : (j + 1) * tile, i * tile : (i + 1) * tile] = vals[s].T
    return k


def _jax_cached_matvec(kd, v, passes):
    """bf16(K) v as the TPU kernel computes it: v split into hi and lo bf16,
    each product at HIGHEST, the parts summed."""
    n = v.shape[0]
    vp = jnp.zeros((kd.shape[0], v.shape[1]), jnp.float32).at[:n].set(jnp.asarray(v))
    vh = vp.astype(jnp.bfloat16).astype(jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    out = jnp.dot(kd, vh, precision=hp)
    if passes == 2:
        vl = (vp - vh).astype(jnp.bfloat16).astype(jnp.float32)
        out = out + jnp.dot(kd, vl, precision=hp)
    return np.asarray(out[:n])


# ---------------------------------------------------------------------------
# K4 and K5, plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, tile", [(1000, 128), (2500, 1024)])
@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k4_matches_jax_tiles(covar, d, n, tile):
    jname, tname = _names(covar)
    x = _points(1, n, d)
    want = _jax_tiles(x, tile, jname)
    got = trbf.rbf_build_sym_tiles(torch.from_numpy(x), tile, tname)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    diff = np.abs(_bits(got).astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("t", [1, 11, 16])
@pytest.mark.parametrize("n, tile", [(1000, 128), (2500, 1024)])
def test_k5_matches_dense_bf16_product(n, tile, t, passes):
    x = _points(2, n, 3)
    bits = _jax_tiles(x, tile, "rbf")
    tiles = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    v = np.random.default_rng(3).normal(size=(n, t)).astype(np.float32)
    want = _jax_cached_matvec(jnp.asarray(_dense_from_tiles(bits, n, tile)), v, passes)
    got = trbf.rbf_matvec_sym_cached(tiles, torch.from_numpy(v), n, tile, passes)
    assert got.shape == (n, t)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_k5_passes_and_refusals():
    n, tile = 700, 128
    x = torch.from_numpy(_points(4, n, 3))
    tiles = trbf.rbf_build_sym_tiles(x, tile)
    v = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 4)).astype(np.float32))
    exact = trbf.kernel_matvec_plain(x, x, v)
    two, one = (trbf.rbf_matvec_sym_cached(tiles, v, n, tile, p) for p in (2, 1))
    # bf16(K) is ~2^-9 from K entrywise; the lo pass removes v's own rounding
    err2, err1 = float((two - exact).abs().max()), float((one - exact).abs().max())
    assert err2 < err1 and err2 <= 2e-2 * float(exact.abs().max())
    with pytest.raises(ValueError, match="passes"):
        trbf.rbf_matvec_sym_cached(tiles, v, n, tile, 3)
    with pytest.raises(ValueError, match="columns"):
        trbf.rbf_matvec_sym_cached(tiles, torch.zeros(n, 17, dtype=torch.float32), n, tile)
    with pytest.raises(ValueError, match="shape mismatch"):
        trbf.rbf_matvec_sym_cached(tiles, v, n, 256)
    with pytest.raises(ValueError, match="multiples of 128"):
        trbf.rbf_build_sym_tiles(x, 100)


# ---------------------------------------------------------------------------
# The closure builder and its gates
# ---------------------------------------------------------------------------


def _operator(x, closure_impl=tkernel.rbf_fused_closure, **kw):
    params = {"lengthscale": _f32(0.8), "outputscale": _f32(1.3)}
    return tkernel.KernelLinearOperator(
        x, x, params, covar_func=tkernel.rbf_covar, symmetric=True,
        matvec_impl=tkernel.rbf_fused_matvec, matvec_closure_impl=closure_impl, **kw,
    )


@pytest.fixture
def open_gates(monkeypatch):
    """The closure builder applies to the CPU and to small n."""
    monkeypatch.setattr(tkernel, "_RBF_CACHE_MIN_N", 0)
    monkeypatch.setattr(tkernel, "_tile_cache_device", lambda x: True)


def test_closure_gates(monkeypatch):
    x = torch.from_numpy(_points(6, 300, 3))
    params = {"lengthscale": _f32(0.8), "outputscale": _f32(1.3)}
    assert tkernel._RBF_CACHE_MIN_N == 24_576 and tkernel.RBF_TILE_CACHE_BUDGET == 11 * 2**30
    # n below the minimum, on any device
    monkeypatch.setattr(tkernel, "_tile_cache_device", lambda x: True)
    assert tkernel.rbf_fused_closure(x, x, params, True) is None
    # CPU tensors: the kernels cannot run (the device gate)
    monkeypatch.undo()
    monkeypatch.setattr(tkernel, "_RBF_CACHE_MIN_N", 0)
    assert tkernel.rbf_fused_closure(x, x, params, True) is None
    # the cache at n = 1e5 fits the budget: 4851 tiles of 2 MiB
    assert 98 * 99 // 2 * 1024**2 * 2 <= tkernel.RBF_TILE_CACHE_BUDGET


def test_closure_gates_with_device_and_size_open(open_gates, monkeypatch):
    x = torch.from_numpy(_points(7, 300, 3))
    params = {"lengthscale": _f32(0.8), "outputscale": _f32(1.3)}
    assert tkernel.rbf_fused_closure(x, x, params, False) is None  # not symmetric
    assert tkernel.rbf_fused_closure(x[None], x[None], params, True) is None  # batched
    closure = tkernel.rbf_fused_closure(x, x, params, True)
    assert closure is not None
    monkeypatch.setattr(tkernel, "RBF_TILE_CACHE_BUDGET", 1024 * 1024 * 2 - 1)  # one tile too many
    assert tkernel.rbf_fused_closure(x, x, params, True) is None
    # the closure: bf16(K) v for a narrow rhs, streaming for a wide one
    v = torch.from_numpy(np.random.default_rng(8).normal(size=(300, 5)).astype(np.float32))
    xs = x / 0.8
    exact = 1.3 * trbf.kernel_matvec_plain(xs, xs, v)
    cached = closure(v)
    assert 0 < float((cached - exact).abs().max()) <= 2e-2 * float(exact.abs().max())
    wide = torch.from_numpy(np.random.default_rng(9).normal(size=(300, 17)).astype(np.float32))
    np.testing.assert_allclose(_np(closure(wide)), _np(1.3 * trbf.kernel_matvec_plain(xs, xs, wide)),
                               rtol=1e-5, atol=1e-5)


def test_closure_takes_precedence_select_cols_drops_it_memory_efficient_bypasses_it(open_gates, monkeypatch):
    calls = []
    real = tkernel.rbf_build_sym_tiles
    monkeypatch.setattr(tkernel, "rbf_build_sym_tiles", lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(_points(10, 400, 3))
    op = _operator(x)
    op._matmul_closure()
    assert calls == [1]
    cols = op._select_cols(torch.arange(0, 400, 7))
    assert cols.matvec_closure_impl is None and cols.matvec_impl is None
    cols._matmul_closure()
    with tlo.settings.memory_efficient(True):
        assert op._matmul_closure() == op._matmul
    # a builder that declines falls through to the dense f32 cache
    assert _operator(x, closure_impl=lambda *a: None)._matmul_closure().__name__ == "cached_mm"
    assert calls == [1]


# ---------------------------------------------------------------------------
# The whole slice against the JAX package
# ---------------------------------------------------------------------------


def _jax_closure_builder(kd):
    """The JAX side of the slice: the same two-pass product with the dense
    bf16(K) ``kd`` (unit outputscale) that the port's tiles stand for.  Both
    sides take one bf16(K): an exp that differs by an f32 ulp flips a bf16
    entry now and then (test_k4_matches_jax_tiles), and one flip near the
    diagonal moves a solve by ~1e-3."""
    kd = jnp.asarray(kd)
    hp = jax.lax.Precision.HIGHEST

    def builder(x1, x2, params, symmetric):
        def closure(rhs):
            vh = rhs.astype(jnp.bfloat16).astype(jnp.float32)
            vl = (rhs - vh).astype(jnp.bfloat16).astype(jnp.float32)
            out = jnp.dot(kd, vh, precision=hp) + jnp.dot(kd, vl, precision=hp)
            return (params["outputscale"] * out).astype(rhs.dtype)

        return closure

    return builder


@pytest.fixture
def same_probes(monkeypatch):
    """Both packages' preconditioner draws return one numpy array."""
    state = {}

    def draws(num_samples, n):
        if "z" not in state:
            state["z"] = np.random.default_rng(11).normal(size=(num_samples, n)).astype(np.float32)
        return state["z"]

    monkeypatch.setattr(JaxLowRank, "zero_mean_mvn_samples",
                        lambda self, s, *, key=None: jnp.asarray(draws(s, self.shape[-1])))
    monkeypatch.setattr(TorchLowRank, "zero_mean_mvn_samples",
                        lambda self, s, *, generator=None: torch.from_numpy(draws(s, self.shape[-1])))


class _Both:
    def __init__(self, **values):
        self.ctxs = [getattr(pkg.settings, k)(v) for k, v in values.items() for pkg in (jlo, tlo)]

    def __enter__(self):
        for c in self.ctxs:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctxs):
            c.__exit__(*exc)


HYPER = (0.8, 1.3, 1.0)  # lengthscale, outputscale, noise: the cache's regime


@pytest.mark.parametrize("mode", ["auto", "pivoted"])
def test_slice_matches_jax(open_gates, same_probes, monkeypatch, mode):
    """inv_quad_logdet with its gradient and solve on the port's cached
    operator (K4 and K5 through their plain versions) against the JAX package
    with the same two-pass dense-bf16 product."""
    calls = {"K4": 0, "K5": 0}
    for name, key in (("rbf_build_sym_tiles", "K4"), ("rbf_matvec_sym_cached", "K5")):
        real = getattr(tkernel, name)
        monkeypatch.setattr(tkernel, name, lambda *a, _f=real, _k=key, **kw: calls.__setitem__(_k, calls[_k] + 1) or _f(*a, **kw))
    n = 1200
    rng = np.random.default_rng(12)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (np.sin(3.0 * x[:, 0]) + rng.normal(size=n)).astype(np.float32)
    rhs = rng.normal(size=(n, 3)).astype(np.float32)
    # CG to 1e-6: two f32 CG runs whose mat-vecs differ in the last bits
    # agree only as far as each has converged
    settings = dict(max_cholesky_size=0, preconditioner_mode=mode, num_trace_samples=6,
                    max_cg_iterations=500, cg_tolerance=1e-6, max_lanczos_quadrature_iterations=20,
                    min_preconditioning_size=1000)

    tiles = trbf.rbf_build_sym_tiles(torch.from_numpy(x / np.float32(HYPER[0])), 1024)
    builder = _jax_closure_builder(_dense_from_tiles(_bits(tiles), n, 1024)[:n, :n])

    def jloss(ls, os_, noise):
        op = jkernel.KernelLinearOperator(
            jnp.asarray(x), jnp.asarray(x), {"lengthscale": ls, "outputscale": os_},
            covar_func=jkernel.rbf_covar, symmetric=True, matvec_closure_impl=builder,
        ).add_diagonal(noise)
        iq, ld = jlo.inv_quad_logdet(op, jnp.asarray(y)[:, None], logdet=True, key=jax.random.PRNGKey(0))
        return 0.5 * (iq + ld) / n, jlo.solve(op, jnp.asarray(rhs))

    leaves = [_f32(h).requires_grad_() for h in HYPER]
    with _Both(**settings):
        (jl, jsol), jg = _jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(h, jnp.float32) for h in HYPER)
        )
        op = tkernel.KernelLinearOperator(
            torch.from_numpy(x), torch.from_numpy(x), {"lengthscale": leaves[0], "outputscale": leaves[1]},
            covar_func=tkernel.rbf_covar, symmetric=True, matvec_impl=tkernel.rbf_fused_matvec,
            matvec_closure_impl=tkernel.rbf_fused_closure,
        ).add_diagonal(leaves[2])
        iq, ld = tlo.inv_quad_logdet(op, torch.from_numpy(y)[:, None], logdet=True, generator=torch.Generator())
        loss = 0.5 * (iq + ld) / n
        loss.backward()
        assert calls["K4"] == 1 and calls["K5"] >= 10
        sol = tlo.solve(op.detach(), torch.from_numpy(rhs))
    assert calls["K4"] == 2
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=1e-4)
    grads = np.array([float(t.grad) for t in leaves])
    jgrads = np.array([float(g) for g in jg])
    np.testing.assert_allclose(grads, jgrads, rtol=1e-4, atol=1e-4 * np.linalg.norm(jgrads))
    want = _np(jsol)
    np.testing.assert_allclose(_np(sol), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
