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
least 99.9% bit-identical (CUDA's expf and torch's exp may differ by an f32
ulp, which now and then crosses a bf16 rounding boundary).  K5 is compared
with its plain version on K4's own tiles, so that it sees only summation
order.
"""

import numpy as np
import pytest
import torch

from linear_operator_tpu_torch import ExactGPRegression, settings
from linear_operator_tpu_torch.operators.kernel import rbf_kernel_operator
from linear_operator_tpu_torch.ops import rbf

COVARS = ["rbf", "matern52", "matern32", "matern12", "rq"]
RTOL = 1e-4
ACC3_RTOL = 1e-5


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
    """K2's two outputs and the assembled dx = 2 (ws x1 - wx) against the
    plain version: dx is a difference of large sums, so it is held too."""
    wx, ws = rbf.kernel_weighted(x1, x2, g, v, name)
    pwx, pws = rbf.kernel_weighted_plain(x1, x2, g, v, name)
    _close(wx, pwx)
    _close(ws, pws)
    _close(2.0 * (ws[..., None] * x1 - wx), 2.0 * (pws[..., None] * x1 - pwx))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k2_matches_plain(cuda, covar, d):
    # ragged n != m of distinct points (Matern-1/2's k' is singular on a
    # coincident pair); t = 11 runs as one column chunk of 12, t = 65 as three
    # of 24; d = 16 takes the quadratic form
    x1, x2, g11, v11, g65, v65 = _data(
        cuda, 12, (700, d), (1000, d), (700, 11), (1000, 11), (700, 65), (1000, 65)
    )
    x1, x2 = x1 / np.sqrt(d), x2 / np.sqrt(d)
    for g, v in ((g11, v11), (g65, v65)):
        _weighted_close(x1, x2, g, v, _name(covar))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5, 33])
def test_k2_every_column_width(cuda, t):
    x1, x2, g, v = _data(cuda, 13, (333, 3), (444, 3), (333, t), (444, t))
    _weighted_close(x1, x2, g, v)


@pytest.mark.cuda
def test_k2_two_splits_and_batch(cuda):
    # m = 5000 spans two of K2's 4096-point partial sums; a batch of 2 is a
    # grid dimension
    x1, x2, g, v = _data(cuda, 14, (2, 300, 3), (2, 5000, 3), (2, 300, 11), (2, 5000, 11))
    wx, ws = rbf.kernel_weighted(x1, x2, g, v)
    want = [rbf.kernel_weighted_plain(x1[b], x2[b], g[b], v[b]) for b in range(2)]
    _close(wx, torch.stack([w[0] for w in want]))
    _close(ws, torch.stack([w[1] for w in want]))
    _weighted_close(x1[0], x2[0], g[0], v[0])


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
@pytest.mark.parametrize("n, tile", [(1000, 128), (3000, 1024)])
@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k4_k5_match_plain(cuda, covar, d, n, tile):
    """K4 for each covariance, and K5 on K4's tiles for t in {1, 11, 16} and
    both passes; n is ragged against the tile."""
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
