"""The port's CUDA kernels (K1-K5) and the backwards of K1 and K3 against
their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; there, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX.)  Errors are taken
relative to the largest entry of the plain result: both sides are f32 sums
of up to n terms in different orders, so they agree to ~sqrt(n) eps of that
scale; rtol 1e-4 leaves a wide margin and a wrong kernel misses it by orders.
K1 and K3 contract as the TPU kernels do (three bf16 products, f32
accumulation), ~1e-5 from full precision: they are held to 1e-4 against the
full-precision plain version and to 1e-5 against ``kernel_matvec_acc3_plain``,
which repeats their arithmetic.
K4's bf16 tiles are held entry by entry: at most one bf16 ulp apart, and at
least 99.9% bit-identical (the kernel's ex2.approx and torch's exp differ by
a few f32 ulps, which now and then crosses a bf16 rounding boundary).  K5 is compared
with its plain version on K4's own tiles, so that it sees only summation
order.  K2 forms g v^T as K1 and K3 contract (three bf16 products): it is
held to ``kernel_weighted_acc3_plain`` at 1e-5 and to full precision at 1e-4.
"""

import contextlib

import numpy as np
import pytest
import torch

from linear_operator_tpu_torch import ExactGPRegression, settings
from linear_operator_tpu_torch.operators.kernel import rbf_kernel_operator
from linear_operator_tpu_torch.ops import rbf

COVARS = ["rbf", "matern52", "matern32", "matern12", "rq"]
RTOL = 1e-4
ACC3_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist each
    worker's torch would start a thread for every core, and the workers'
    spinning threads slow each other (``test_torch_harness_common.py``'s
    fixture, repeated here because that module imports JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _name(covar):
    return rbf.rq_tile_covar(1.5) if covar == "rq" else covar


def _data(dev, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev) for s in shapes]


def _close(got, want, rtol=RTOL):
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


def _both_close(got, x1, x2, v, name="rbf"):
    """K1 or K3 against both plain versions: its own arithmetic to 1e-5,
    full precision to 1e-4."""
    _close(got, rbf.kernel_matvec_acc3_plain(x1, x2, v, name), ACC3_RTOL)
    _close(got, rbf.kernel_matvec_plain(x1, x2, v, name))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_kernels_match_plain(cuda, covar, d):
    # n = 1000 is ragged against every tile; d = 16 takes the quadratic form
    x, v11, v65 = _data(cuda, 6, (1000, d), (1000, 11), (1000, 65))
    x = x / np.sqrt(d)
    name = _name(covar)
    for v in (v11, v65):
        _close(rbf.kernel_matvec(x, x, v, name), rbf.kernel_matvec_plain(x, x, v, name))
    _close(rbf.kernel_matvec_sym(x, v11, name), rbf.kernel_matvec_plain(x, x, v11, name))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5, 16])
def test_k3_every_column_width(cuda, t):
    x, v = _data(cuda, 7, (333, 3), (333, t))
    _close(rbf.kernel_matvec_sym(x, v), rbf.kernel_matvec_plain(x, x, v))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k1_k3_match_both_plain_versions(cuda, covar, d):
    """Ragged edges: n = 1000 is no multiple of 16 or 128, m = 5000 no
    multiple of 64 and spans two 4096-point splits; K3 at t = 1, 11, 16 (one
    and two n8 blocks), K1 at t = 1, 65, 72 (one chunk) and 73 (two).  At
    d > 8 the coordinates lie on a 1/64 grid, where the quadratic form is
    exact in f32: otherwise the plain versions' rounding leaves a point
    ~1e-7 from itself, which Matern-1/2's sqrt turns into ~3e-4 of its
    diagonal entry (the kernels keep that distance exactly 0)."""
    x, x2 = _data(cuda, 40 + d, (1000, d), (5000, d))
    x, x2 = x / np.sqrt(d), x2 / np.sqrt(d)
    if d > 8:
        x, x2 = torch.round(64 * x) / 64, torch.round(64 * x2) / 64
    name = _name(covar)
    for t in (1, 11, 16):
        (v,) = _data(cuda, 50 + t, (1000, t))
        _both_close(rbf.kernel_matvec_sym(x, v, name), x, x, v, name)
    for t in (1, 65, 72, 73):
        (v,) = _data(cuda, 60 + t, (5000, t))
        _both_close(rbf.kernel_matvec(x, x2, v, name), x, x2, v, name)


@pytest.mark.cuda
def test_k1_k3_batch_match_both_plain_versions(cuda):
    x, v, v65 = _data(cuda, 70, (2, 700, 3), (2, 700, 11), (2, 700, 65))
    for b in range(2):
        _both_close(rbf.kernel_matvec_sym(x, v)[b], x[b], x[b], v[b])
        _both_close(rbf.kernel_matvec(x, x, v65)[b], x[b], x[b], v65[b])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16])
def test_k3_is_symmetric(cuda, d):
    """u^T (K w) = w^T (K u) for u and w exact in bf16 (their lo parts are
    0) and nonnegative (neither side is a cancelling sum): K3 forms each
    off-diagonal pair once and uses it both ways."""
    (x,) = _data(cuda, 71, (3000, d))
    u, w = (a.abs().to(torch.bfloat16).float() for a in _data(cuda, 72, (3000, 1), (3000, 1)))
    kw, ku = rbf.kernel_matvec_sym(x / np.sqrt(d), w), rbf.kernel_matvec_sym(x / np.sqrt(d), u)
    a, b = float((u.double() * kw.double()).sum()), float((w.double() * ku.double()).sum())
    assert abs(a - b) <= 1e-5 * abs(a), (a, b)


@pytest.mark.cuda
def test_k1_rectangular_and_split(cuda):
    # m > 4096 spans two of K1's partial-sum splits; n != m
    x1, x2, v = _data(cuda, 8, (300, 3), (5000, 3), (5000, 40))
    _close(rbf.kernel_matvec(x1, x2, v), rbf.kernel_matvec_plain(x1, x2, v))


@pytest.mark.cuda
def test_batch_is_a_grid_dimension(cuda):
    x, v = _data(cuda, 9, (3, 200, 3), (3, 200, 11))
    want = torch.stack([rbf.kernel_matvec_plain(x[b], x[b], v[b]) for b in range(3)])
    _close(rbf.kernel_matvec_sym(x, v), want)
    _close(rbf.kernel_matvec(x, x, v), want)


@pytest.mark.cuda
def test_fused_operator_on_the_card(cuda):
    """The dispatcher with the dense cache off: lengthscale and outputscale
    outside the kernels, K3 for a narrow rhs, K1 for a wide one."""
    x, v11, v65 = _data(cuda, 10, (500, 3), (500, 11), (500, 65))
    op = rbf_kernel_operator(x, lengthscale=0.7, outputscale=1.3, materialize_threshold=None)
    counts = (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches)
    for v in (v11, v65):
        _close(op._matmul_closure()(v), 1.3 * rbf.kernel_matvec_plain(x / 0.7, x / 0.7, v))
    assert (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches) == (counts[0] + 1, counts[1] + 1)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x, v = _data(cuda, 11, (64, 3), (64, 4))
    with pytest.raises(TypeError, match="float32"):
        rbf.kernel_matvec_sym(x.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        rbf.kernel_matvec(x, x, v.mT.contiguous().mT)
    with pytest.raises(ValueError, match="CUDA"):
        rbf.kernel_matvec(x, x.cpu(), v)


def _weighted_close(x1, x2, g, v, name="rbf"):
    """K2's two outputs and the assembled dx = 2 (ws x1 - wx) against both
    plain versions: its own arithmetic (g v^T through dot_acc3) to 1e-5, full
    precision to 1e-4.  dx is a difference of large sums, so it is held too."""
    wx, ws = rbf.kernel_weighted(x1, x2, g, v, name)
    dx = 2.0 * (ws[..., None] * x1 - wx)
    for plain, rtol in ((rbf.kernel_weighted_acc3_plain, ACC3_RTOL), (rbf.kernel_weighted_plain, RTOL)):
        pwx, pws = plain(x1, x2, g, v, name)
        _close(wx, pwx, rtol)
        _close(ws, pws, rtol)
        _close(dx, 2.0 * (pws[..., None] * x1 - pwx), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k2_matches_plain(cuda, covar, d):
    """Ragged n = 700 against m = 5000 points, which span two of K2's
    4096-point partial sums; t = 1, 11, 16 take one k-step of 16, t = 33 and
    65 several.  d > 8 takes the quadratic form, on a 1/64 grid where it is
    exact in f32.  At d = 1, x2 lies on a 1/8 grid and x1 on that grid
    shifted by 1/16: Matern-1/2's k' = -e^{-r} / (2r) is unbounded as a pair
    closes, and 3.5e6 random pairs on a line come within r ~ 1e-6 (weight
    ~5e5), where the f32 rounding of ws x1 and W x2 (each ~5e5) swamps their
    difference dx (~1e2) in any two summation orders: there the f32 plain
    version lies 1.5e-3 of dx from an f64 run, on a 1/64 grid shifted by
    1/128 still 1.1e-5, on this one 3e-6 (measured on the CPU)."""
    x1, x2 = _data(cuda, 12 + d, (700, d), (5000, d))
    x1, x2 = x1 / np.sqrt(d), x2 / np.sqrt(d)
    if d > 8:
        x1, x2 = torch.round(64 * x1) / 64, torch.round(64 * x2) / 64
    elif d == 1:
        x1, x2 = (torch.round(8 * x1) + 0.5) / 8, torch.round(8 * x2) / 8
    for t in (1, 11, 16, 33, 65):
        g, v = _data(cuda, 100 + t, (700, t), (5000, t))
        _weighted_close(x1, x2, g, v, _name(covar))


@pytest.mark.cuda
@pytest.mark.parametrize("t", range(1, rbf.WEIGHTED_MAX_COLUMNS + 1))
def test_k2_every_column_width(cuda, t):
    x1, x2, g, v = _data(cuda, 13, (333, 3), (444, 3), (333, t), (444, t))
    _weighted_close(x1, x2, g, v)


@pytest.mark.cuda
def test_k2_two_splits_and_batch(cuda):
    # m = 5000 spans two of K2's 4096-point partial sums; a batch of 2 is a
    # grid dimension
    x1, x2, g, v = _data(cuda, 14, (2, 300, 3), (2, 5000, 3), (2, 300, 11), (2, 5000, 11))
    wx, ws = rbf.kernel_weighted(x1, x2, g, v)
    for plain, rtol in ((rbf.kernel_weighted_acc3_plain, ACC3_RTOL), (rbf.kernel_weighted_plain, RTOL)):
        want = [plain(x1[b], x2[b], g[b], v[b]) for b in range(2)]
        _close(wx, torch.stack([w[0] for w in want]), rtol)
        _close(ws, torch.stack([w[1] for w in want]), rtol)
    _weighted_close(x1[0], x2[0], g[0], v[0])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [129, 201, 256])
def test_k2_past_128_columns(cuda, t):
    """t above 128 runs as column chunks of at most 128, one launch each,
    whose sums add: t = 129 as 128 + 1, 201 as 128 + 73, 256 as 128 + 128."""
    x1, x2, g, v = _data(cuda, 33, (700, 3), (5000, 3), (700, t), (5000, t))
    k2 = rbf.kernel_weighted.launches
    _weighted_close(x1, x2, g, v)
    assert rbf.kernel_weighted.launches == k2 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [129, 200, 256])
def test_kernels_past_128_dimensions(cuda, d):
    """K1, K2, K3 and K4 at d > 128, on a 1/64 grid where the quadratic form
    is exact in f32."""
    x1, x2 = (torch.round(64 * a / np.sqrt(d)) / 64 for a in _data(cuda, 80 + d, (700, d), (900, d)))
    v, g, w = _data(cuda, 81, (900, 11), (700, 11), (700, 11))
    _both_close(rbf.kernel_matvec(x1, x2, v), x1, x2, v)
    _both_close(rbf.kernel_matvec_sym(x1, w), x1, x1, w)
    _weighted_close(x1, x2, g, v)
    for tile in (128, 1024):
        _tiles_close(rbf.rbf_build_sym_tiles(x1, tile), rbf.rbf_build_sym_tiles_plain(x1, tile))


@pytest.mark.cuda
def test_batch_past_the_grid_limit(cuda):
    """A batch of 65537 runs K1, K2 and K3 in two launches each (65535 + 2):
    the batch is a grid dimension of at most 65535."""
    x, v = _data(cuda, 82, (65537, 16, 3), (65537, 16, 5))
    counts = (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches, rbf.kernel_weighted.launches)
    _both_close(rbf.kernel_matvec(x, x, v), x, x, v)
    _both_close(rbf.kernel_matvec_sym(x, v), x, x, v)
    wx, ws = rbf.kernel_weighted(x, x, v, v)
    for plain, rtol in ((rbf.kernel_weighted_acc3_plain, ACC3_RTOL), (rbf.kernel_weighted_plain, RTOL)):
        pwx, pws = plain(x, x, v, v)
        _close(wx, pwx, rtol)
        _close(ws, pws, rtol)
    assert (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches, rbf.kernel_weighted.launches) == tuple(
        c + 2 for c in counts
    )


def _grads(fn, *inputs, weights):
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(torch.sum(out * weights), leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("covar", ["rbf", "matern52"])
def test_backwards_match_autograd_of_plain(cuda, covar):
    """K1's dx1, dx2, dv and K3's dx, dv (autograd through the wrappers, so
    through K2, K1 and K3) against autograd through the plain version."""
    x1, x2, v, w1, x, vs, ws = _data(
        cuda, 15, (600, 3), (900, 3), (900, 11), (600, 11), (800, 3), (800, 11), (800, 11)
    )
    k2 = rbf.kernel_weighted.launches
    got = _grads(lambda a, b, c: rbf.kernel_matvec(a, b, c, covar), x1, x2, v, weights=w1)
    want = _grads(lambda a, b, c: rbf.kernel_matvec_plain(a, b, c, covar), x1, x2, v, weights=w1)
    for a, b in zip(got, want):
        _close(a, b)
    got = _grads(lambda a, c: rbf.kernel_matvec_sym(a, c, covar), x, vs, weights=ws)
    want = _grads(lambda a, c: rbf.kernel_matvec_plain(a, a, c, covar), x, vs, weights=ws)
    for a, b in zip(got, want):
        _close(a, b)
    assert rbf.kernel_weighted.launches == k2 + 4


@pytest.mark.cuda
def test_training_step_fused_matches_plain(cuda):
    """neg_mll(...).backward() on the fused model (K3 forward, K2 backward)
    against the plain model on the same probes: the three raw-parameter
    gradients agree to 1e-3 of their norm.  CG runs to a tight tolerance:
    at the benchmark's cg_tolerance(1.0) the f32 CG trajectories of two
    mat-vecs that differ in the last bits part by ~1e-2 at this n (measured
    on the CPU, where both paths take the plain versions), which would hide
    what is compared here, the kernels."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(3000, 3)).astype(np.float32)).to(cuda)
    y = torch.sin(3.0 * x[:, 0]) + 0.1 * torch.from_numpy(rng.normal(size=3000).astype(np.float32)).to(cuda)
    grads = []
    for fused in (True, False):
        model = ExactGPRegression(use_fused_kernels=fused, materialize_threshold=None)
        with settings.max_cholesky_size(0), settings.num_trace_samples(10), \
                settings.preconditioner_mode("auto"), settings.max_cg_iterations(1000), \
                settings.cg_tolerance(1e-4):
            k2 = rbf.kernel_weighted.launches
            loss = model.neg_mll(x, y, generator=torch.Generator().manual_seed(0))
            loss.backward()
        assert rbf.kernel_weighted.launches == k2 + (2 if fused else 0)
        grads.append(torch.stack([model.raw_lengthscale.grad, model.raw_outputscale.grad, model.raw_noise.grad]))
    assert torch.isfinite(grads[0]).all()
    err = float(torch.linalg.norm(grads[0] - grads[1]))
    assert err <= 1e-3 * float(torch.linalg.norm(grads[1])), (grads, err)


def _tiles_close(got, want):
    """K4's tiles: <= 1 bf16 ulp per entry, >= 99.9% bit-identical."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    diff = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    assert int(diff.max()) <= 1, int(diff.max())
    assert float((diff == 0).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("n, tile", [(1000, 128), (600, 256), (700, 384), (1300, 512), (3000, 1024), (2500, 2048)])
@pytest.mark.parametrize("d", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k4_k5_match_plain(cuda, covar, d, n, tile):
    """K4 for each covariance, and K5 on K4's tiles for t in {1, 11, 16} and
    both passes; n is ragged against the tile.  K4's work items are R x C =
    16384 entries with C the widest of 1024, 512, 256, 128 that divides the
    tile: 16 whole tile rows at tile 1024, two column blocks a band at tile
    2048, C = 512 at tile 512, 256 at tile 256, 128 at tiles 128 and 384."""
    (x,) = _data(cuda, 17, (n, d))
    x = x / np.sqrt(d)
    tiles = rbf.rbf_build_sym_tiles(x, tile, _name(covar))
    _tiles_close(tiles, rbf.rbf_build_sym_tiles_plain(x, tile, _name(covar)))
    for t in (1, 11, 16):
        (v,) = _data(cuda, 18 + t, (n, t))
        for passes in (1, 2):
            _close(rbf.rbf_matvec_sym_cached(tiles, v, n, tile, passes),
                   rbf.rbf_matvec_sym_cached_plain(tiles, v, n, tile, passes))


@pytest.mark.cuda
@pytest.mark.parametrize("t", range(1, rbf.SYM_MAX_COLUMNS + 1))
def test_k5_every_column_width(cuda, t):
    """K5 at every t, both passes, on ragged n for tile 128 (n = 1000: a
    ragged 128-row strip) and tile 1024 (n = 2500: a ragged last tile)."""
    for n, tile in ((1000, 128), (2500, 1024)):
        x, v = _data(cuda, 34 + t, (n, 3), (n, t))
        tiles = rbf.rbf_build_sym_tiles(x, tile)
        for passes in (1, 2):
            _close(rbf.rbf_matvec_sym_cached(tiles, v, n, tile, passes),
                   rbf.rbf_matvec_sym_cached_plain(tiles, v, n, tile, passes))


@pytest.mark.cuda
@pytest.mark.parametrize("n, tile", [(3000, 128), (5000, 1024)])
def test_k5_is_symmetric(cuda, n, tile):
    """u^T (M w) = w^T (M u) for the cached operator M, with u and w exact in
    bf16 (the lo pass adds nothing) and nonnegative (no cancelling sums): K5
    uses each off-diagonal sub-block for rows and, transposed, for columns."""
    (x,) = _data(cuda, 73, (n, 3))
    u, w = (a.abs().to(torch.bfloat16).float() for a in _data(cuda, 74, (n, 1), (n, 1)))
    tiles = rbf.rbf_build_sym_tiles(x, tile)
    mw, mu = (rbf.rbf_matvec_sym_cached(tiles, a, n, tile) for a in (w, u))
    a, b = float((u.double() * mw.double()).sum()), float((w.double() * mu.double()).sum())
    assert abs(a - b) <= 1e-5 * abs(a), (a, b)


@pytest.mark.cuda
def test_k4_k5_past_32_bit_offsets(cuda):
    """n = 64,600, tile 1024: 2080 tile pairs, 2.18e9 entries, so the last
    tiles sit past 2^31 elements of the cache."""
    n, tile = 64_600, 1024
    x, v = _data(cuda, 30, (n, 3), (n, 11))
    tiles = rbf.rbf_build_sym_tiles(x, tile)
    assert tiles.numel() > 2**31
    want = rbf.rbf_build_sym_tiles_plain(x, tile)
    _tiles_close(tiles[-64:], want[-64:])
    _tiles_close(tiles, want)
    del want
    _close(rbf.rbf_matvec_sym_cached(tiles, v, n, tile), rbf.rbf_matvec_sym_cached_plain(tiles, v, n, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("covar", COVARS)
def test_k4_every_covariance_past_32_bit_offsets(cuda, covar):
    """K4 for each covariance at n = 64,600, tile 1024 (2.18e9 entries), on
    points spread as the GP main path's (a lengthscale of 0.69): far pairs
    reach the subnormal tail of k, which K4 keeps as the plain version does."""
    n, tile = 64_600, 1024
    (x,) = _data(cuda, 83, (n, 3))
    x = x / 0.69
    tiles = rbf.rbf_build_sym_tiles(x, tile, _name(covar))
    assert tiles.numel() > 2**31
    want = rbf.rbf_build_sym_tiles_plain(x, tile, _name(covar))
    for s in range(0, tiles.shape[0], 256):
        _tiles_close(tiles[s : s + 256], want[s : s + 256])


@pytest.mark.cuda
def test_posterior_backward_matches_plain(cuda):
    """The gradient of sum(mean) + sum(var) of the posterior at m = 200 query
    points: the solve's 201 columns go to K1, and its backward (an
    unpreconditioned CG on the transpose, then K1's backward) makes two K2
    calls of 201 columns, two launches each.  Against the plain model on the
    same inputs, to 1e-3 of the gradient's norm, with CG run to 1e-4."""
    rng = np.random.default_rng(84)
    x = torch.from_numpy(rng.normal(size=(3000, 3)).astype(np.float32)).to(cuda)
    y = torch.sin(3.0 * x[:, 0]) + 0.1 * torch.from_numpy(rng.normal(size=3000).astype(np.float32)).to(cuda)
    x_star = torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32)).to(cuda)
    grads = []
    for fused in (True, False):
        model = ExactGPRegression(use_fused_kernels=fused, materialize_threshold=None)
        with settings.max_cholesky_size(0), settings.preconditioner_mode("auto"), \
                settings.max_cg_iterations(1000), settings.cg_tolerance(1e-4):
            mean, var = model.posterior(x, y, x_star)
            k2 = rbf.kernel_weighted.launches
            (mean.sum() + var.sum()).backward()
        assert rbf.kernel_weighted.launches == k2 + (4 if fused else 0)
        grads.append(torch.stack([model.raw_lengthscale.grad, model.raw_outputscale.grad, model.raw_noise.grad]))
    assert torch.isfinite(grads[0]).all()
    err = float(torch.linalg.norm(grads[0] - grads[1]))
    assert err <= 1e-3 * float(torch.linalg.norm(grads[1])), (grads, err)


@pytest.mark.cuda
def test_k4_k5_refuse_what_they_do_not_take(cuda):
    x, v = _data(cuda, 31, (300, 3), (300, 4))
    with pytest.raises(TypeError, match="float32"):
        rbf.rbf_build_sym_tiles(x.double(), 128)
    with pytest.raises(ValueError, match="multiples of 128"):
        rbf.rbf_build_sym_tiles(x, 96)
    tiles = rbf.rbf_build_sym_tiles(x, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        rbf.rbf_matvec_sym_cached(tiles.float(), v, 300, 128)
    with pytest.raises(TypeError, match="float32"):
        rbf.rbf_matvec_sym_cached(tiles, v.double(), 300, 128)
    with pytest.raises(ValueError, match="contiguous"):
        rbf.rbf_matvec_sym_cached(tiles, v.mT.contiguous().mT, 300, 128)
    with pytest.raises(ValueError, match="columns"):
        rbf.rbf_matvec_sym_cached(tiles, torch.zeros(300, 17, device=cuda), 300, 128)
    with pytest.raises(ValueError, match="shape mismatch"):
        rbf.rbf_matvec_sym_cached(tiles, v, 300, 256)
    with pytest.raises(ValueError, match="CUDA"):
        rbf.rbf_matvec_sym_cached(tiles, v.cpu(), 300, 128)


@pytest.mark.cuda
def test_tile_cache_operator_on_the_card(cuda):
    """rbf_fused_closure on the card: one K4 launch per closure, one K5 launch
    per narrow mat-vec, K1 for a wide one; bf16(K) v is ~2^-9 from K v."""
    from linear_operator_tpu_torch.operators import kernel as tkernel

    n = tkernel._RBF_CACHE_MIN_N
    x, v, w = _data(cuda, 32, (n, 3), (n, 11), (n, 20))
    op = tkernel.KernelLinearOperator(
        x, x, {"lengthscale": torch.tensor(0.8, device=cuda), "outputscale": torch.tensor(1.3, device=cuda)},
        covar_func=tkernel.rbf_covar, symmetric=True, matvec_impl=tkernel.rbf_fused_matvec,
        matvec_closure_impl=tkernel.rbf_fused_closure,
    )
    counts = (rbf.rbf_build_sym_tiles.launches, rbf.rbf_matvec_sym_cached.launches, rbf.kernel_matvec.launches)
    closure = op._matmul_closure()
    cached = closure(v)
    wide = closure(w)
    assert (rbf.rbf_build_sym_tiles.launches, rbf.rbf_matvec_sym_cached.launches,
            rbf.kernel_matvec.launches) == (counts[0] + 1, counts[1] + 1, counts[2] + 1)
    exact = 1.3 * rbf.kernel_matvec_sym(x / 0.8, v)
    err = float((cached - exact).abs().max()) / float(exact.abs().max())
    assert 0 < err <= 2e-2, err
    _close(wide, 1.3 * rbf.kernel_matvec_plain(x / 0.8, x / 0.8, w))


def _gp_data(dev, seed, n=3000, m=200):
    """x (n, 3), y = sin(3 x_0) + 0.1 eps, x_star (m, 3) on the card."""
    x, eps, x_star = _data(dev, seed, (n, 3), (n,), (m, 3))
    return x, torch.sin(3.0 * x[:, 0]) + 0.1 * eps, x_star


@contextlib.contextmanager
def _love_settings():
    """The LOVE cache's settings (the JAX benchmark's config 3d, k = 100),
    with CG run to 1e-4: at cg_tolerance(1.0) the f32 CG trajectories of two
    mat-vecs that differ in the last bits part by ~1e-2 at this n (see
    test_training_step_fused_matches_plain), which would hide the kernels."""
    with settings.max_cholesky_size(0), settings.preconditioner_mode("auto"), settings.max_cg_iterations(1000), \
            settings.cg_tolerance(1e-4), settings.max_root_decomposition_size(100):
        yield


@pytest.mark.cuda
def test_lanczos_loop_never_waits_for_the_card(cuda):
    """50 Lanczos steps on the fused operator at n = 3000 under
    torch.cuda.set_sync_debug_mode("error"): no step reads the device, so
    the 50 K3 launches queue behind each other."""
    from linear_operator_tpu_torch.solvers.lanczos import lanczos_tridiag

    x, init = _data(cuda, 90, (3000, 3), (3000,))
    model = ExactGPRegression(materialize_threshold=None)
    with torch.no_grad():
        K = model.train_operator(x)
        lanczos_tridiag(K._matmul, 2, init_vecs=init)  # loads K3 before the check
        torch.cuda.synchronize()
        k3 = rbf.kernel_matvec_sym.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            q, t = lanczos_tridiag(K._matmul, 50, init_vecs=init)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert rbf.kernel_matvec_sym.launches == k3 + 50
    assert torch.isfinite(q).all() and torch.isfinite(t).all()
    assert float((q.mT @ q - torch.eye(50, device=cuda)).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_love_query_makes_two_k1_launches(cuda):
    """posterior_from_cache: k_* alpha (t = 1) and k_* R (t = 100), one K1
    launch each; no K3 launch and no solve."""
    x, y, x_star = _gp_data(cuda, 91)
    model = ExactGPRegression(materialize_threshold=None)
    with _love_settings(), torch.no_grad():
        cache = model.posterior_cache(x, y, generator=torch.Generator().manual_seed(0))
        before = (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches, rbf.kernel_weighted.launches)
        mean, var = model.posterior_from_cache(x, cache, x_star)
        after = (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches, rbf.kernel_weighted.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 0, 0)
    assert cache.root_inv.shape == (3000, 100) and mean.shape == var.shape == (200,)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [None, 1.0])
def test_love_fused_matches_plain(cuda, noise):
    """The LOVE cache and a batch of 200 queries on the fused model against the
    plain model at n = 3000, one generator seed for both (the same Lanczos
    start): the mean to 1e-3 of max|mean|, the variance to 1e-3 of the prior
    variance; at the model's initial noise (0.127) and at noise 1.0."""
    x, y, x_star = _gp_data(cuda, 92)
    out = []
    for fused in (True, False):
        model = ExactGPRegression(use_fused_kernels=fused, materialize_threshold=None)
        if noise is not None:
            with torch.no_grad():
                model.raw_noise.fill_(float(np.log(np.expm1(noise - 1e-6))))
        with _love_settings(), torch.no_grad():
            cache = model.posterior_cache(x, y, generator=torch.Generator().manual_seed(0))
            out.append(model.posterior_from_cache(x, cache, x_star))
            prior = float(model.covariance(x_star).diagonal().max())
    (mean, var), (mean_p, var_p) = out
    assert float((mean - mean_p).abs().max()) <= 1e-3 * float(mean_p.abs().max())
    assert float((var - var_p).abs().max()) <= 1e-3 * prior


@pytest.mark.cuda
def test_inverse_root_backward_matches_plain(cuda):
    """The gradient of sum((b^T R)^2), R the Lanczos inverse root (k = 100) of
    the training operator, with respect to the raw parameters: on the fused
    path the backward's one bilinear form has 4k = 400 columns, which K1's
    backward sends to K2 twice (the x1 and x2 partials), each call in four
    launches of 128, 128, 128 and 16 columns.  Against the plain model to
    5e-3 of the gradient's norm: 100 f32 Lanczos steps carry K3's summation
    order (its atomics) into this gradient at ~1e-3 of its norm on this data
    (``chip_smoke.py`` phase 9 reports two fused runs, the plain path and
    the f64 one side by side), where a wrong backward misses by orders."""
    x, b = _data(cuda, 93, (3000, 3), (3000,))
    widths, launch = [], rbf._launch_weighted

    def record(a, x2, g, v, spec):
        widths.append(g.shape[-1])
        return launch(a, x2, g, v, spec)

    grads = []
    for fused in (True, False):
        model = ExactGPRegression(use_fused_kernels=fused, materialize_threshold=None)
        widths.clear()
        rbf._launch_weighted = record
        try:
            with _love_settings():
                R = model.train_operator(x).root_inv_decomposition(generator=torch.Generator().manual_seed(0))
                torch.sum((b @ R.root.to_dense()) ** 2).backward()
        finally:
            rbf._launch_weighted = launch
        assert widths == ([128, 128, 128, 16] * 2 if fused else [])
        grads.append(torch.stack([model.raw_lengthscale.grad, model.raw_outputscale.grad, model.raw_noise.grad]))
    assert torch.isfinite(grads[0]).all()
    err = float(torch.linalg.norm(grads[0] - grads[1]))
    assert err <= 5e-3 * float(torch.linalg.norm(grads[1])), (grads, err)


# ---------------------------------------------------------------------------
# The exact Woodbury operator and CIQ sampling (config 1 and config 6)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_woodbury_on_the_card_matches_cpu_f64(cuda):
    """The exact Woodbury operator in f32 on the card against the same
    operator in f64 on the CPU: solve, inv_quad_logdet, logdet (f32 closed
    forms, full-f32 products: ~1e-7 relative), and no kernel launch."""
    from linear_operator_tpu_torch.operators import DenseLinearOperator, LowRankRootLinearOperator

    n, r = 200_000, 20
    rng = np.random.default_rng(94)
    U = rng.normal(size=(n, r)) / np.sqrt(n)
    d = 0.5 + 0.1 * rng.uniform(size=n)
    y = rng.normal(size=(n, 2))
    before = {k: getattr(rbf, k).launches for k in ("kernel_matvec", "kernel_matvec_sym", "kernel_weighted")}
    outs = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        def t(a):
            return torch.tensor(a, dtype=dtype, device=device)

        op = LowRankRootLinearOperator(DenseLinearOperator(t(U))).add_diagonal(t(d)).factorize()
        iq, ld = op.inv_quad_logdet(t(y), logdet=True)
        outs.append([op.solve(t(y)), iq, ld, op.logdet()])
    for got, want in zip(*outs):
        got = got.double().cpu()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert before == {k: getattr(rbf, k).launches for k in before}


def _ciq_settings():
    stack = contextlib.ExitStack()
    for c in [settings.ciq_samples(True), settings.minres_tolerance(1e-3), settings.num_contour_quadrature(15),
              settings.preconditioner_mode("auto")]:
        stack.enter_context(c)
    return stack


@contextlib.contextmanager
def _k3_widths():
    """K3's launches inside the block, by width."""
    widths, launch = [], rbf._launch_matvec_sym

    def record(a, w, spec):
        widths.append(w.shape[-1])
        return launch(a, w, spec)

    rbf._launch_matvec_sym = record
    try:
        yield widths
    finally:
        rbf._launch_matvec_sym = launch


@pytest.mark.cuda
def test_ciq_sampling_fused_matches_plain(cuda):
    """16 CIQ draws and sqrt_inv_matmul at n = 4096 (the rank-64 Nystrom
    preconditioner on) through the kernels against the plain path, the same
    generator seed: relative Frobenius 1e-3.  K3 runs at t = 1 (the range
    estimate) and t = 16 (MINRES), never wider."""
    from linear_operator_tpu_torch import sqrt_inv_matmul

    (x,) = _data(cuda, 95, (4096, 3))
    z = torch.randn(4096, 16, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    outs = []
    for fused in (True, False):
        model = ExactGPRegression(use_fused_kernels=fused)
        with _ciq_settings(), torch.no_grad(), _k3_widths() as widths:
            K = model.train_operator(x)
            s = K.zero_mean_mvn_samples(16, generator=torch.Generator(device=cuda).manual_seed(0))
            h = sqrt_inv_matmul(K, z, generator=torch.Generator(device=cuda).manual_seed(2))
        assert sorted(set(widths)) == ([1, 16] if fused else [])
        outs.append((s, h))
    for got, want in zip(*outs):
        assert torch.isfinite(got).all()
        assert float((got - want).norm()) <= 1e-3 * float(want.norm())


@pytest.mark.cuda
def test_ciq_backward_chunks_k2(cuda):
    """The backward of sum(sqrt_inv_matmul(K, z)^2) stacks 15 shifts x 16
    columns into one bilinear form of 240 columns: K1 once, and K2 twice in
    two launches of 128 and 112 columns each; no K3 wider than 16.  Its
    gradient against the plain path's to 1e-3 of the norm."""
    from linear_operator_tpu_torch import sqrt_inv_matmul

    (x,) = _data(cuda, 96, (4096, 3))
    z = torch.randn(4096, 16, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    widths, launch = [], rbf._launch_weighted

    def record(a, x2, g, v, spec):
        widths.append(g.shape[-1])
        return launch(a, x2, g, v, spec)

    grads = []
    for fused in (True, False):
        model = ExactGPRegression(use_fused_kernels=fused)
        widths.clear()
        rbf._launch_weighted = record
        try:
            with _ciq_settings(), _k3_widths() as k3:
                out = sqrt_inv_matmul(model.train_operator(x), z, generator=torch.Generator(device=cuda).manual_seed(4))
                torch.sum(out**2).backward()
        finally:
            rbf._launch_weighted = launch
        assert widths == ([128, 112] * 2 if fused else [])
        assert max(k3, default=0) <= 16
        grads.append(torch.stack([model.raw_lengthscale.grad, model.raw_outputscale.grad, model.raw_noise.grad]))
    assert torch.isfinite(grads[0]).all()
    assert float(torch.linalg.norm(grads[0] - grads[1])) <= 1e-3 * float(torch.linalg.norm(grads[1]))


# ---------------------------------------------------------------------------
# The structured operators and SKI (no kernel of ops/rbf.py on these paths)
# ---------------------------------------------------------------------------


def _launches():
    return [w.launches for w in (rbf.kernel_matvec, rbf.kernel_matvec_sym, rbf.kernel_weighted,
                                 rbf.rbf_build_sym_tiles, rbf.rbf_matvec_sym_cached)]


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _structured_ops(dev, dtype):
    """The structured operators of the port at small sizes, all built from
    one seeded numpy draw: {name: operator}."""
    from linear_operator_tpu_torch import operators as ops

    rng = np.random.default_rng(120)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    def psd(n):
        a = rng.normal(size=(n, n))
        return t(a @ a.T + n * np.eye(n))

    col = np.exp(-0.5 * (np.arange(40) / 6.0) ** 2)
    col[0] += 1.0
    kron = ops.KroneckerProductLinearOperator(ops.DenseLinearOperator(psd(5)), ops.DenseLinearOperator(psd(6)))
    kron3 = ops.KroneckerProductLinearOperator(*(ops.DenseLinearOperator(psd(n)) for n in (2, 3, 5)))
    kdiag = ops.KroneckerProductDiagLinearOperator(
        ops.DiagLinearOperator(t(rng.uniform(0.5, 1.5, 5))), ops.DiagLinearOperator(t(rng.uniform(0.5, 1.5, 6))))
    li, ri = rng.integers(0, 30, size=(2, 25, 4))
    lv, rv = rng.uniform(size=(2, 25, 4))
    sizes = (6, 5)
    gi = tuple(torch.tensor(rng.integers(0, m, size=(25, 2)), device=dev) for m in sizes)
    gv = tuple(t(rng.uniform(size=(25, 2))) for _ in sizes)
    return {
        "toeplitz": ops.ToeplitzLinearOperator(t(col)),
        "kron": kron,
        "kron3": kron3,
        "kron+c": kron.add_diagonal(t(0.7)),
        "kron+kdiag": kron + kdiag,
        "kron+kron": kron + ops.KroneckerProductLinearOperator(ops.DenseLinearOperator(psd(5)),
                                                               ops.DenseLinearOperator(psd(6))),
        "interpolated": ops.InterpolatedLinearOperator(ops.DenseLinearOperator(psd(30)),
                                                       torch.tensor(li, device=dev), t(lv), torch.tensor(ri, device=dev), t(rv)),
        "grid": ops.GridInterpolatedLinearOperator(ops.DenseLinearOperator(psd(30)), gi, gv, gi, gv, sizes),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("fft", [False, True])
def test_structured_operators_match_cpu_f64(cuda, fft):
    """Each new operator's mat-vec, transposed mat-vec and diagonal in f32
    on the card against f64 on the CPU (1e-5 of the largest entry), and the
    closed forms (solve, inv_quad, logdet) where the operator has them
    (1e-4); no kernel launch."""
    gpu, cpu = _structured_ops(cuda, torch.float32), _structured_ops("cpu", torch.float64)
    before = _launches()
    with settings.toeplitz_fft_min_size(0 if fft else 4096):
        for name, op in gpu.items():
            ref = cpu[name]
            rhs = torch.tensor(np.random.default_rng(121).normal(size=(op.shape[-1], 3)))
            assert _rel(op @ rhs.float().to(cuda), ref @ rhs) <= 1e-5, name
            assert _rel(op._t_matmul(rhs[: op.shape[-2]].float().to(cuda)), ref._t_matmul(rhs[: op.shape[-2]])) <= 1e-5, name
            if op.is_square:
                assert _rel(op.diagonal(), ref.diagonal()) <= 1e-5, name
            if name.startswith("kron") and name != "kron3":
                iq, ld = op.inv_quad_logdet(rhs.float().to(cuda), logdet=True)
                riq, rld = ref.inv_quad_logdet(rhs, logdet=True)
                assert _rel(op._solve_structure(rhs.float().to(cuda)), ref._solve_structure(rhs)) <= 1e-4, name
                assert _rel(iq, riq) <= 1e-4 and _rel(ld, rld) <= 1e-4, name
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 11])
def test_interpolation_on_the_card_matches_cpu_f64(cuda, t):
    """W (gather), W^T (index_add) and W K W^T at n = 4096 on a 64 x 64 grid
    on the card against the dense f64 interpolation matrix on the CPU, to
    1e-5 of the largest entry."""
    from linear_operator_tpu_torch.models.ski import SKIGPRegression, make_grid
    from linear_operator_tpu_torch.operators.interpolated import _interp_to_dense

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.rand(4096, 2, device=cuda, generator=g)
    model = SKIGPRegression(make_grid(x, (64, 64)))
    op = model.covariance(x)
    v = torch.randn(4096, t, device=cuda, generator=g)
    v_grid = torch.randn(64 * 64, t, device=cuda, generator=g)
    with torch.no_grad():
        cpu = SKIGPRegression(model.grid, dtype=torch.float64, device="cpu").covariance(x.double().cpu())
        w = _interp_to_dense(cpu._left)
        vc, vgc = v.double().cpu(), v_grid.double().cpu()
        assert _rel(op._left.matmul(v_grid), w @ vgc) <= 1e-5
        assert _rel(op._right.t_matmul(v), w.mT @ vc) <= 1e-5
        assert _rel(op._matmul(v), w @ cpu.base.to_dense() @ (w.mT @ vc)) <= 1e-5


@pytest.mark.cuda
def test_toeplitz_fft_route_at_8192(cuda):
    """A Toeplitz of 8192 takes the FFT route by default (>= 4096) and
    agrees with the dense f64 product to 1e-5 of its largest entry."""
    from linear_operator_tpu_torch.models.ski import rbf_toeplitz_column
    from linear_operator_tpu_torch.operators import ToeplitzLinearOperator

    col = rbf_toeplitz_column(8192, 1.0 / 8191, torch.tensor(0.05, device=cuda))
    op = ToeplitzLinearOperator(col)
    v = torch.randn(8192, 4, device=cuda, generator=torch.Generator(device=cuda).manual_seed(6))
    assert op._uses_fft()
    want = ToeplitzLinearOperator(col.double()).to_dense() @ v.double()
    assert _rel(op @ v, want) <= 1e-5


@pytest.mark.cuda
def test_config4_and_ski_launch_no_kernel(cuda):
    """Config 4's step (at m = 60) and SKI's neg_mll with its backward (at
    n = 8192) run no kernel of ops/rbf.py; config 4's forward runs no CG."""
    from linear_operator_tpu_torch import inv_quad_logdet, make_grid, solve
    from linear_operator_tpu_torch.models.ski import SKIGPRegression, rbf_toeplitz_column
    from linear_operator_tpu_torch.operators import KroneckerProductLinearOperator, ToeplitzLinearOperator

    before = _launches()
    ls = torch.tensor(0.3, device=cuda, requires_grad=True)
    op = KroneckerProductLinearOperator(*(ToeplitzLinearOperator(rbf_toeplitz_column(60, 0.05, s * ls))
                                          for s in (1.0, 1.3))).add_diagonal(0.1)
    y = torch.randn(3600, 1, device=cuda, generator=torch.Generator(device=cuda).manual_seed(7))
    iq, ld = inv_quad_logdet(op, y, logdet=True)
    (solve(op, y).sum() + iq.sum() + ld.sum()).backward()
    assert torch.isfinite(ls.grad)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.rand(8192, 2, device=cuda, generator=g)
    model = SKIGPRegression(make_grid(x, (64, 64)))
    model.neg_mll(x, torch.sin(6 * x[:, 0]), generator=g).backward()
    assert torch.isfinite(model.raw_noise.grad)
    assert _launches() == before


@pytest.mark.cuda
def test_ski_default_settings_step_does_not_densify(cuda):
    """SKI's neg_mll and backward at n = 20,000 under the default settings
    (the rank-15 pivoted preconditioner reads the operator through its
    structured _get_indices): the peak device memory stays far below the
    1.6 GB of one dense f32 20,000^2 matrix."""
    from linear_operator_tpu_torch import make_grid
    from linear_operator_tpu_torch.models.ski import SKIGPRegression

    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.rand(20_000, 2, device=cuda, generator=g)
    y = torch.sin(6.0 * x[:, 0]) * torch.cos(4.0 * x[:, 1])
    model = SKIGPRegression(make_grid(x, (64, 64)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model.neg_mll(x, y, generator=g).backward()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 256 * 2**20
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 11])
def test_kernel_row_selection_launches_k1(cuda, t):
    """K[idx] stays a kernel operator on the gathered rows; its mat-vec is
    one K1 launch, held against both plain versions."""
    x, v = _data(cuda, 30, (6000, 3), (6000, t))
    idx = torch.randperm(6000, generator=torch.Generator().manual_seed(31))[:300].to(cuda)
    op = rbf_kernel_operator(x, lengthscale=0.7, outputscale=1.3, materialize_threshold=None)
    sub = op[idx]
    assert type(sub).__name__ == "KernelLinearOperator" and not sub.symmetric
    k1, k3 = rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches
    got = sub @ v
    assert (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches) == (k1 + 1, k3)
    xs = x / 0.7
    _both_close(got / 1.3, xs[idx], xs, v)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [(slice(0, 3000), slice(0, 3000)), (slice(1000, 5000, 2), slice(1000, 5000, 2))])
def test_kernel_principal_block_launches_k3(cuda, index):
    """K[s, s] stays a symmetric kernel operator; its mat-vec is one K3
    launch, held against both plain versions; K[s, s'] is one K1 launch."""
    x, v = _data(cuda, 32, (6000, 3), (6000, 4))
    op = rbf_kernel_operator(x, lengthscale=0.7, outputscale=1.3, materialize_threshold=None)
    sub = op[index]
    assert type(sub).__name__ == "KernelLinearOperator" and sub.symmetric
    xs = (x / 0.7)[index[0]]
    w = v[: xs.shape[0]]
    k1, k3 = rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches
    got = sub @ w
    assert (rbf.kernel_matvec.launches, rbf.kernel_matvec_sym.launches) == (k1, k3 + 1)
    _both_close(got / 1.3, xs, xs, w)
    rect = op[index[0], slice(0, 2000)]
    assert not rect.symmetric
    got = rect @ v[:2000]
    assert rbf.kernel_matvec.launches == k1 + 1
    _both_close(got / 1.3, xs, (x / 0.7)[:2000], v[:2000])


# the operators of the kernel family on the card: each fused covariance
# against its plain route, with the launches by covariance id
FAMILY = {
    "matern52": (dict(nu=2.5), 1),
    "matern32": (dict(nu=1.5), 2),
    "matern12": (dict(nu=0.5), 3),
    "rq": (dict(alpha=2.0), 4),
}


def _family_operator(family, x, x2=None, fused=True, **kw):
    from linear_operator_tpu_torch.operators.kernel import matern_kernel_operator, rq_kernel_operator

    extra, _ = FAMILY[family]
    make = rq_kernel_operator if family == "rq" else matern_kernel_operator
    return make(x, x2, lengthscale=torch.tensor([0.6, 0.7, 0.8], device=x.device), outputscale=0.693,
                use_fused_kernels=fused, materialize_threshold=None, **extra, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILY))
def test_kernel_family_fused_matches_plain(cuda, family):
    """Each covariance's fused operator (K3 for a narrow symmetric rhs, K1
    for a cross-covariance, K2 in the backward) against its plain route on
    the card, with every launch under the covariance's id and none under
    another."""
    x, xs, v, g = _data(cuda, 40, (3000, 3), (64, 3), (3000, 11), (3000, 11))
    covar_id = FAMILY[family][1]
    rbf.reset_launch_counts()
    op, plain = _family_operator(family, x), _family_operator(family, x, fused=False)
    _close(op @ v, plain @ v, 1e-4)
    cross, cross_plain = _family_operator(family, xs, x), _family_operator(family, xs, x, fused=False)
    _close(cross @ v, cross_plain @ v, 1e-4)
    leaves = [x.clone().requires_grad_() for _ in range(2)]
    grads = [torch.autograd.grad(torch.sum(g * (_family_operator(family, a, fused=f) @ v)), a)[0]
             for a, f in zip(leaves, (True, False))]
    _close(grads[0], grads[1], 1e-3)
    # K3: the mat-vec and the gradient's forward; K2: the gradient's two
    # halves of dx (x is both arguments); K1: the cross-covariance
    assert rbf.kernel_matvec_sym.launches_by_covar == {covar_id: 2}
    assert rbf.kernel_matvec.launches_by_covar == {covar_id: 1}
    assert rbf.kernel_weighted.launches_by_covar == {covar_id: 2}


@pytest.mark.cuda
def test_registered_covariance_runs_its_cuda_bodies_in_the_kernels(cuda):
    """A covariance registered with CUDA bodies is compiled into builds of
    K1, K3, K2 and K4 of its own and launches them under id 5 (COVAR_USER),
    each against its plain version; the built-in covariances keep their
    default builds."""
    name = rbf.register_tile_covar("cuda_test_cauchy", lambda d2: 1.0 / (1.0 + d2), lambda d2: -1.0 / (1.0 + d2) ** 2,
                                   cuda_covar="1.0f / (1.0f + d2)",
                                   cuda_dcovar="-1.0f / ((1.0f + d2) * (1.0f + d2))")
    x1, x2, v, g = _data(cuda, 41, (500, 3), (700, 3), (700, 4), (500, 4))
    rbf.reset_launch_counts()
    _close(rbf.kernel_matvec(x1, x2, v, name), rbf.kernel_matvec_plain(x1, x2, v, name))
    _close(rbf.kernel_matvec(x1, x2, v, name), rbf.kernel_matvec_acc3_plain(x1, x2, v, name), ACC3_RTOL)
    _close(rbf.kernel_matvec_sym(x1, g, name), rbf.kernel_matvec_plain(x1, x1, g, name))
    for got, want in zip(rbf.kernel_weighted(x1, x2, g, v, name), rbf.kernel_weighted_plain(x1, x2, g, v, name)):
        _close(got, want)
    _tiles_close(rbf.rbf_build_sym_tiles(x1, 128, name), rbf.rbf_build_sym_tiles_plain(x1, 128, name))
    counts = [w.launches_by_covar for w in (rbf.kernel_matvec, rbf.kernel_matvec_sym, rbf.kernel_weighted,
                                            rbf.rbf_build_sym_tiles)]
    assert counts == [{5: 2}, {5: 1}, {5: 1}, {5: 1}]
    # the gradients: K2 twice through K1's backward, K1 again for dv
    leaves = [a.clone().requires_grad_() for a in (x1, x2, v)]
    grads = torch.autograd.grad(torch.sum(g * rbf.kernel_matvec(*leaves, name)), leaves)
    want = torch.autograd.grad(torch.sum(g * rbf.kernel_matvec_plain(*leaves, name)), leaves)
    for got, ref in zip(grads, want):
        _close(got, ref)
    assert rbf.kernel_weighted.launches_by_covar == {5: 3} and rbf.kernel_matvec.launches_by_covar == {5: 4}
    rbf.kernel_matvec(x1, x2, v, "matern52")
    assert rbf.kernel_matvec.launches_by_covar == {5: 4, 1: 1}


@pytest.mark.cuda
def test_registered_covariance_without_cuda_bodies_raises_on_the_card(cuda):
    """A covariance registered with torch functions alone has no CUDA id:
    every wrapper raises on CUDA tensors before any launch, and none runs a
    plain version on the card."""
    name = rbf.register_tile_covar("cuda_test_bare", lambda d2: 1.0 / (1.0 + d2), lambda d2: -1.0 / (1.0 + d2) ** 2)
    x1, x2, v, g = _data(cuda, 42, (50, 3), (70, 3), (70, 4), (50, 4))
    rbf.reset_launch_counts()
    for call in (lambda: rbf.kernel_matvec(x1, x2, v, name), lambda: rbf.kernel_matvec_sym(x1, g, name),
                 lambda: rbf.kernel_weighted(x1, x2, g, v, name), lambda: rbf.rbf_build_sym_tiles(x1, 128, name)):
        with pytest.raises(ValueError, match="without CUDA bodies"):
            call()
    assert [w.launches for w in (rbf.kernel_matvec, rbf.kernel_matvec_sym, rbf.kernel_weighted,
                                 rbf.rbf_build_sym_tiles)] == [0, 0, 0, 0]


# ---------------------------------------------------------------------------
# The inducing-point, classification, multitask and deep-kernel models
# ---------------------------------------------------------------------------


def _model_case(kind, device, dtype, x, y):
    """A model of ``kind`` on ``device`` and its loss on (x, y)."""
    from linear_operator_tpu_torch import models

    if kind == "multitask":
        model = models.MultitaskGPRegression(4, 2, dtype=dtype, device=device)
        yy = torch.stack([torch.sin(3.0 * x[:, 0] + i) for i in range(4)], dim=-1)
        return model, lambda: model.neg_mll(x, yy)
    if kind == "sgpr":
        model = models.SGPRRegression(x, 32, device=device)
        return model, lambda: model.neg_elbo(x, y)
    cls, kw, target = {
        "svgp": (models.SVGPRegression, {}, y),
        "probit": (models.SVGPClassification, {"likelihood": "probit"}, (y > 0).to(dtype)),
        "logit": (models.SVGPClassification, {"likelihood": "logit"}, (y > 0).to(dtype)),
        "poisson": (models.SVGPPoissonRegression, {}, torch.round(torch.exp(y))),
    }[kind]
    model = cls(x, 32, device=device, **kw)
    return model, lambda: model.neg_elbo(x, target, num_data=10 * x.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sgpr", "svgp", "probit", "logit", "poisson", "multitask"])
def test_models_on_the_card_match_cpu_f64(cuda, kind):
    """Each closed-form model's loss and gradients (every parameter) in f32
    on the card against the same model in f64 on the CPU, the same
    parameters (q moved off the prior): 1e-3 (f32 Cholesky factors of m = 32 inducing points and
    eigendecompositions of 1000 x 1000 factors); no kernel launches."""
    (x,) = _data(cuda, 120, (1000, 3))
    y = torch.sin(3.0 * x[:, 0])
    before = {k: getattr(rbf, k).launches for k in ("kernel_matvec", "kernel_matvec_sym", "kernel_weighted")}
    card, card_loss = _model_case(kind, cuda, torch.float32, x, y)
    if hasattr(card, "var_mean"):
        # q off the prior: at the prior the predictive is k_ii whatever the
        # lengthscale and z, whose gradients are then rounding alone
        m = card.var_mean.shape[0]
        mean, root = _data(cuda, 122, (m,), (m, m))
        with torch.no_grad():
            card.var_mean.copy_(0.5 * mean)
            card.var_root_raw.add_(0.1 * root)
    cpu, cpu_loss = _model_case(kind, "cpu", torch.float64, x.cpu().double(), y.cpu().double())
    cpu.load_state_dict(card.state_dict())
    losses = []
    for model, loss_fn in ((card, card_loss), (cpu, cpu_loss)):
        loss = loss_fn()
        loss.backward()
        losses.append(float(loss.detach()))
    assert before == {k: getattr(rbf, k).launches for k in before}
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1]), losses
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        if q.grad is None:  # the classifier's raw_noise
            assert p.grad is None, name
            continue
        err = float((p.grad.cpu().double() - q.grad).norm())
        assert err <= 1e-3 * float(q.grad.norm()) + 1e-6, (name, err)


@pytest.mark.cuda
def test_dkl_fused_gradients_match_the_plain_path(cuda):
    """DKL's training step through the kernels (K3 each CG iteration, two K2
    launches in the backward carrying the gradient into the MLP) against the
    plain path on the same probes: the loss and the first layer's weight
    gradient, with CG run to 1e-4."""
    from linear_operator_tpu_torch.models import DeepKernelGPRegression

    (x,) = _data(cuda, 121, (4096, 8))
    y = torch.sin(3.0 * x[:, 0])
    results = []
    for fused in (True, False):
        model = DeepKernelGPRegression(8, (64, 32, 2), generator=torch.Generator().manual_seed(0),
                                       use_fused_kernels=fused, materialize_threshold=None)
        rbf.reset_launch_counts()
        with settings.max_cholesky_size(0), settings.cg_tolerance(1e-4), settings.max_cg_iterations(500), \
                settings.num_trace_samples(10):
            loss = model.neg_mll(x, y, generator=torch.Generator().manual_seed(1))
            fwd = rbf.kernel_matvec_sym.launches
            loss.backward()
        launched = (fwd, rbf.kernel_matvec_sym.launches - fwd, rbf.kernel_weighted.launches)
        assert launched[0] > 0 and launched[1:] == (1, 2) if fused else launched == (0, 0, 0), launched
        results.append((float(loss.detach()), model.mlp[0].weight.grad.double()))
    (l_fused, g_fused), (l_plain, g_plain) = results
    assert torch.isfinite(g_fused).all() and float(g_fused.abs().max()) > 0.0
    assert abs(l_fused - l_plain) <= 1e-3 * abs(l_plain), (l_fused, l_plain)
    assert float((g_fused - g_plain).norm()) <= 1e-2 * float(g_plain.norm())


@pytest.mark.cuda
def test_psd_safe_cholesky_gradient_on_the_card(cuda):
    """A matrix whose first Cholesky fails on the card (its factor there holds
    NaN): the gradient is cholesky(A + jitter I)'s, finite, and matches the
    CPU's in f64."""
    from linear_operator_tpu_torch.utils.cholesky import psd_safe_cholesky, psd_safe_cholesky_ex

    b, w = _data("cpu", 123, (64, 40), (64, 64))
    A = (b @ b.mT - 1e-4 * torch.eye(64)).double()
    grads = []
    for device in (cuda, "cpu"):
        At = A.to(device).requires_grad_()
        torch.sum(psd_safe_cholesky(At, jitter=1e-3, max_tries=3) * w.double().to(device)).backward()
        grads.append(At.grad.cpu())
    assert float(psd_safe_cholesky_ex(A.to(cuda), jitter=1e-3, max_tries=3).jitter) > 0
    assert torch.isfinite(grads[0]).all()
    assert float((grads[0] - grads[1]).norm()) <= 1e-8 * float(grads[1].norm())
