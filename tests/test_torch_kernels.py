"""The port's fused kernel mat-vecs (K1, K3), their weighted-tile backward
kernel (K2) and the backwards of K1 and K3 against the JAX package.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the JAX side runs K1 and K2 in Pallas interpret mode (a 3-pass bf16 product,
~1e-5 relative to exact f32, hence rtol 1e-4 for K1, K2 and every gradient)
and K3 through its dense f32 HIGHEST fallback (rtol 1e-5).
``kernel_matvec_acc3_plain``, which repeats the 3-pass product as the CUDA
K1 and K3 compute it, is held to the Pallas K1 at 3e-6, and
``kernel_weighted_acc3_plain`` (g v^T as the CUDA K2 forms it) to the Pallas
K2's rowsum(W) at 1e-6.  Errors are taken
relative to the largest entry of the result (``atol = rtol * max|ref|``): a sum of signed terms has
entries near 0 whose relative error means nothing.  Inputs are made with a
seeded numpy generator and handed to both packages.

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linear_operator_tpu.ops import rbf as jrbf
from linear_operator_tpu_torch import _build, kernel_variants
from linear_operator_tpu_torch.operators.kernel import rbf_kernel_operator
from linear_operator_tpu_torch.ops import rbf as trbf
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COVARS = ["rbf", "matern52", "matern32", "matern12", "rq"]


def _names(covar):
    """(JAX name, port name) of a covariance; rq registers alpha = 1.5."""
    if covar == "rq":
        return jrbf.rq_tile_covar(1.5), trbf.rq_tile_covar(1.5)
    return covar, covar


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k1_plain_matches_jax(covar, d):
    # m = 520 spans two of JAX's 512-point tiles, n = 300 is ragged
    x1, x2, v = _data(0, (300, d), (520, d), (520, 7))
    scale = np.float32(1.0 / np.sqrt(d))  # keep kernel entries away from 0
    x1, x2 = x1 * scale, x2 * scale
    jname, tname = _names(covar)
    want = jrbf.kernel_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), 512, jname)
    got = trbf.kernel_matvec(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(v), tname)
    assert got.shape == (300, 7) and got.dtype == torch.float32
    _close(got, want, 1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dot_acc3_matches_jax(seed):
    # the operands of a kernel tile contraction: entries in (0, 1] against a
    # normal rhs, and a ragged inner dimension
    k, v = _data(seed, (64, 300), (300, 11))
    k = np.exp(-0.5 * k * k).astype(np.float32)
    want = jrbf._dot_acc3(jnp.asarray(k), jnp.asarray(v), (((1,), (0,)), ((), ())))
    got = trbf.dot_acc3(torch.from_numpy(k), torch.from_numpy(v))
    _close(got, want, 3e-6)
    # three bf16 passes are not the full-precision product: they drop lo x lo
    full = k.astype(np.float64) @ v.astype(np.float64)
    _close(got, full, 1e-4)
    assert np.abs(got.numpy() - full).max() > 1e-7 * np.abs(full).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k1_acc3_plain_matches_jax(covar, d, seed):
    """The plain version in the kernels' own arithmetic against the Pallas
    K1 in interpret mode, which contracts with _dot_acc3: 30x tighter than
    the full-precision plain version's 1e-4, which it misses by ~1e-5."""
    x1, x2, v = _data(seed, (300, d), (520, d), (520, 7))
    scale = np.float32(1.0 / np.sqrt(d))
    x1, x2 = x1 * scale, x2 * scale
    jname, tname = _names(covar)
    want = jrbf.kernel_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), 512, jname)
    args = (torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(v), tname)
    got = trbf.kernel_matvec_acc3_plain(*args)
    assert got.shape == (300, 7) and got.dtype == torch.float32
    _close(got, want, 3e-6)
    _close(got, trbf.kernel_matvec_plain(*args), 1e-4)


@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k3_plain_matches_jax(covar, d):
    x, v = _data(1, (300, d), (300, 11))
    x = x / np.float32(np.sqrt(d))
    jname, tname = _names(covar)
    want = jrbf.kernel_matvec_sym(jnp.asarray(x), jnp.asarray(v), 1024, jname)
    got = trbf.kernel_matvec_sym(torch.from_numpy(x), torch.from_numpy(v), tname)
    # Matern-1/2 is sqrt(d2)-sharp at d2 = 0.  With d > 8 both packages take
    # the quadratic form, whose f32 rounding leaves a point ~1e-7 from itself
    # in an order-dependent way; the sqrt turns that into ~3e-4 in the
    # diagonal entry, so there the two agree only to that order.
    _close(got, want, 1e-3 if (covar, d) == ("matern12", 16) else 1e-5)


@pytest.mark.parametrize("t", [11, 20])
def test_fused_dispatcher_matches_jax(t):
    """The port's KernelLinearOperator with the dense cache off runs the fused
    dispatcher: K3 for t <= 16, K1 above, with the lengthscale prescale and
    the outputscale outside the kernels."""
    x, v = _data(2, (300, 3), (300, t))
    ls, os_ = 0.7, 1.3
    op = rbf_kernel_operator(
        torch.from_numpy(x), lengthscale=ls, outputscale=os_, materialize_threshold=None
    )
    got = op._matmul_closure()(torch.from_numpy(v))
    want = os_ * np.asarray(
        jrbf.kernel_matvec_sym(jnp.asarray(x / np.float32(ls)), jnp.asarray(v), 1024, "rbf")
    )
    _close(got, want, 1e-5)
    assert trbf.sym_matvec_supported(t) == (t <= trbf.SYM_MAX_COLUMNS)


def test_sym_gate():
    assert [trbf.sym_matvec_supported(t) for t in (0, 1, 11, 16, 17, 65)] == [
        False, True, True, True, False, False,
    ]
    x, v = _data(3, (50, 3), (50, 17))
    with pytest.raises(ValueError, match="rhs columns"):
        trbf.kernel_matvec_sym(torch.from_numpy(x), torch.from_numpy(v))


def test_k1_column_chunks():
    """K1 forms each entry once up to 72 columns (t = 65 in one chunk of 72);
    a wider rhs runs in as few chunks as possible, each padded to a width the
    kernel is built for."""
    widths = [trbf._k1_columns(t) for t in (1, 8, 9, 11, 33, 65, 72, 73, 145)]
    assert widths == [8, 8, 16, 16, 48, 72, 72, 48, 72]
    assert all(w in trbf.K1_COLUMNS for w in widths)


@pytest.mark.parametrize("t", [3, 4, 7])
def test_column_chunks_and_batch_groups_match_one_call(t):
    """The card runs K2's columns in chunks of at most 128 (summed) and the
    batches of K1, K2 and K3 in groups of at most 65535 (concatenated), all
    through ``_in_groups``.  Driven here with the plain versions at a chunk of
    2 columns and groups of 2 over a batch of 5, against one call."""
    x1, x2, g, v = (torch.from_numpy(a) for a in _data(9, (5, 40, 3), (5, 50, 3), (5, 40, t), (5, 50, t)))
    launches = []

    def plain_k2(*args):
        launches.append(args[2].shape)
        return trbf.kernel_weighted_plain(*args)

    wx, ws = trbf._in_groups(plain_k2, [x1, x2, g, v], columns=(2, 3), max_batch=2, max_columns=2)
    assert len(launches) == 3 * -(-t // 2)
    assert {s[-1] for s in launches} == ({2, 1} if t % 2 else {2})
    pwx, pws = trbf.kernel_weighted_plain(x1, x2, g, v)
    _close(wx, pwx, 1e-6)
    _close(ws, pws, 1e-6)
    _close(trbf._in_groups(trbf.kernel_matvec_plain, [x1, x2, v], max_batch=2),
           trbf.kernel_matvec_plain(x1, x2, v), 1e-6)
    _close(trbf._in_groups(lambda a, w: trbf.kernel_matvec_plain(a, a, w), [x1, g], max_batch=2),
           trbf.kernel_matvec_plain(x1, x1, g), 1e-6)


@pytest.mark.parametrize("t", [129, 201])
def test_k2_plain_matches_jax_past_128_columns(t):
    """The widths the card runs in column chunks (t = 201: the posterior
    backward at m = 200; t = 129: a training step under 128 probes): both
    plain versions against the Pallas K2 in interpret mode, which pads t to a
    multiple of 128, at the tolerances of test_k2_plain_matches_jax and
    test_k2_acc3_plain_matches_jax."""
    x1, x2, g, v = _data(11, (64, 3), (48, 3), (64, t), (48, t))
    jwx, jws = jrbf._pallas_weighted(*map(jnp.asarray, (x1, x2, g, v)), 64, "rbf")
    args = [torch.from_numpy(a) for a in (x1, x2, g, v)]
    wx, ws = trbf.kernel_weighted(*args)
    _close(wx, jwx, 1e-4)
    _close(ws, jws, 1e-4)
    _close(_dx(wx, ws, x1), _dx(jwx, jws, x1), 1e-4)
    awx, aws = trbf.kernel_weighted_acc3_plain(*args)
    _close(aws, jws, 1e-6)
    _close(awx, jwx, 3e-5)
    _close(_dx(awx, aws, x1), _dx(jwx, jws, x1), 3e-5)


def _launch_counts():
    return (trbf.kernel_matvec.launches, trbf.kernel_matvec_sym.launches, trbf.kernel_weighted.launches)


def test_cpu_runs_plain_version_and_counts_no_launch():
    x, v, g = _data(4, (64, 3), (64, 5), (64, 5))
    x, v, g = (torch.from_numpy(a) for a in (x, v, g))
    before = _launch_counts()
    a = trbf.kernel_matvec(x, x, v)
    b = trbf.kernel_matvec_sym(x, v)
    wx, ws = trbf.kernel_weighted(x, x, g, v)
    xg = x.clone().requires_grad_()
    torch.sum(trbf.kernel_matvec_sym(xg, v) * g).backward()
    assert _launch_counts() == before
    plain = trbf.kernel_matvec_plain(x, x, v)
    torch.testing.assert_close(a, plain, rtol=0, atol=0)
    torch.testing.assert_close(b, plain, rtol=0, atol=0)
    pwx, pws = trbf.kernel_weighted_plain(x, x, g, v)
    torch.testing.assert_close(wx, pwx, rtol=0, atol=0)
    torch.testing.assert_close(ws, pws, rtol=0, atol=0)
    assert torch.isfinite(xg.grad).all()


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    x = torch.empty((8, 3), device="meta")
    v = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        trbf.kernel_matvec(x, x, v)
    with pytest.raises(ValueError, match="CUDA"):
        trbf.kernel_matvec_sym(torch.zeros(8, 3), v)
    with pytest.raises(ValueError, match="CUDA"):
        trbf.kernel_weighted(x, x, v, v)


# ---------------------------------------------------------------------------
# K2 and the backwards of K1 and K3
# ---------------------------------------------------------------------------


def _dx(wx, ws, x1):
    return 2.0 * (np.asarray(ws)[:, None] * np.asarray(x1) - np.asarray(wx))


# every covariance at d = 3, the quadratic form (d = 16) for two, and a wide
# rhs (t = 65, the posterior gradient's width, which the card runs as five
# k-steps of one pass)
K2_CASES = [(c, 3, 11) for c in COVARS] + [
    ("rbf", 16, 11), ("matern12", 16, 11), ("matern32", 3, 65), ("rbf", 3, 65),
]


@pytest.mark.parametrize("covar, d, t", K2_CASES)
def test_k2_plain_matches_jax(covar, d, t):
    # n = 300 ragged, m = 520 spans two of JAX's 512-point tiles
    x1, x2, g, v = _data(5, (300, d), (520, d), (300, t), (520, t))
    scale = np.float32(1.0 / np.sqrt(d))
    x1, x2 = x1 * scale, x2 * scale
    jname, tname = _names(covar)
    jwx, jws = jrbf._pallas_weighted(*map(jnp.asarray, (x1, x2, g, v)), 512, jname)
    wx, ws = trbf.kernel_weighted(*map(torch.from_numpy, (x1, x2, g, v)), tname)
    assert wx.shape == (300, d) and ws.shape == (300,)
    _close(wx, jwx, 1e-4)
    _close(ws, jws, 1e-4)
    # the assembled gradient, a difference of the two sums
    _close(_dx(wx, ws, x1), _dx(jwx, jws, x1), 1e-4)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("covar", COVARS)
def test_k2_acc3_plain_matches_jax(covar, d, seed):
    """The plain version of K2 in the card's arithmetic (g v^T through
    dot_acc3) against the Pallas K2 in interpret mode, which forms g v^T with
    _dot_acc3 too.  rowsum(W) agrees to 1e-6, 5x tighter than the
    full-precision plain version's ~5e-6; W x2 and dx only to 3e-5, because
    the TPU kernel also contracts W with x2 by _dot_acc3 (~1e-5), where the
    card and this plain version sum W x2 in f32."""
    x1, x2, g, v = _data(seed, (300, d), (520, d), (300, 11), (520, 11))
    scale = np.float32(1.0 / np.sqrt(d))
    x1, x2 = x1 * scale, x2 * scale
    if d > 8:
        # a 1/16 grid, where the quadratic form is exact in f32 (see
        # test_k3_backward_matches_jax: Matern-1/2 on coincident points)
        x1, x2 = (np.round(16 * a).astype(np.float32) / np.float32(16) for a in (x1, x2))
    jname, tname = _names(covar)
    jwx, jws = jrbf._pallas_weighted(*map(jnp.asarray, (x1, x2, g, v)), 512, jname)
    args = [torch.from_numpy(a) for a in (x1, x2, g, v)]
    wx, ws = trbf.kernel_weighted_acc3_plain(*args, tname)
    assert wx.shape == (300, d) and ws.shape == (300,) and wx.dtype == torch.float32
    _close(ws, jws, 1e-6)
    _close(wx, jwx, 3e-5)
    _close(_dx(wx, ws, x1), _dx(jwx, jws, x1), 3e-5)
    pwx, pws = trbf.kernel_weighted_plain(*args, tname)
    _close(wx, pwx, 1e-4)
    _close(ws, pws, 1e-4)


def _torch_grads(fn, inputs, weights):
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    torch.sum(fn(*leaves) * torch.from_numpy(weights)).backward()
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("covar, d", [("rbf", 3), ("matern52", 3), ("matern12", 16)])
def test_k1_backward_matches_jax(covar, d):
    """dx1, dx2 and dv of K1 (two K2 plain calls and K1 transposed) against
    jax.grad through the JAX package's custom VJP."""
    x1, x2, v, w = _data(6, (300, d), (520, d), (520, 7), (300, 7))
    scale = np.float32(1.0 / np.sqrt(d))
    x1, x2 = x1 * scale, x2 * scale
    jname, tname = _names(covar)

    def f(a, b, c):
        return jnp.sum(jrbf.kernel_matvec(a, b, c, 512, jname) * w)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (x1, x2, v)))
    got = _torch_grads(lambda a, b, c: trbf.kernel_matvec(a, b, c, tname), (x1, x2, v), w)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("covar, d", [("rbf", 3), ("matern32", 3), ("rq", 3), ("matern12", 16)])
def test_k3_backward_matches_jax(covar, d):
    """dx (both K2 partials of k(x, x)) and dv of K3 against jax.grad."""
    x, v, w = _data(7, (300, d), (300, 11), (300, 11))
    # Coordinates on a 1/16 grid: at d > 8 both packages take the quadratic
    # form, which is then exact in f32, so each point is at distance 0 from
    # itself in both.  Otherwise its rounding leaves a point ~1e-7 from
    # itself, in an order-dependent way, and Matern-1/2 gives that pair a
    # weight of 0 in one package and ~-e^{-d}/(2d) ~ -1e3 in the other: its
    # exact contribution, (x_i - x_i), is 0, but in ws x - wx it cancels only
    # to f32 rounding (measured 6e-3 of the largest entry).
    x = np.round(16 * x / np.sqrt(d)).astype(np.float32) / np.float32(16)
    jname, tname = _names(covar)

    def f(a, c):
        return jnp.sum(jrbf.kernel_matvec_sym(a, c, 1024, jname) * w)

    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(v))
    got = _torch_grads(lambda a, c: trbf.kernel_matvec_sym(a, c, tname), (x, v), w)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


def test_backward_computes_only_what_is_needed(monkeypatch):
    """A constant v costs K3's backward no K3 call; a constant x no K2 call."""
    calls = []
    real_sym, real_weighted = trbf._kernel_matvec_sym, trbf.kernel_weighted
    monkeypatch.setattr(trbf, "_kernel_matvec_sym", lambda *a: calls.append("K3") or real_sym(*a))
    monkeypatch.setattr(trbf, "kernel_weighted", lambda *a: calls.append("K2") or real_weighted(*a))
    x, v, w = (torch.from_numpy(a) for a in _data(8, (40, 3), (40, 4), (40, 4)))
    torch.sum(trbf.kernel_matvec_sym(x.clone().requires_grad_(), v) * w).backward()
    assert calls == ["K3", "K2", "K2"]
    calls.clear()
    torch.sum(trbf.kernel_matvec_sym(x, v.clone().requires_grad_()) * w).backward()
    assert calls == ["K3", "K3"]


def test_kernel_sources_hash_into_library_names():
    assert _build.sources() == [
        "kernel_build_sym", "kernel_matvec", "kernel_matvec_cached", "kernel_matvec_sym", "kernel_weighted",
    ]
    paths = {_build.library_path(name) for name in _build.sources()}
    assert len(paths) == 5 and all(p.parent == _build.BUILD_DIR for p in paths)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_registered_covariance_builds_hash_its_cuda_bodies():
    """A registered covariance's CUDA bodies go into a pre-included header,
    whose text keys builds of their own beside the default ones."""
    header = _build.covar_header("1.0f / (1.0f + d2)", "-1.0f / ((1.0f + d2) * (1.0f + d2))")
    assert "#define LO_USER_COVAR 1" in header and "float user_dcovar(float d2)" in header
    other = _build.covar_header("1.0f / (1.0f + 2.0f * d2)", "-2.0f / ((1.0f + 2.0f * d2) * (1.0f + 2.0f * d2))")
    paths = {_build.library_path("kernel_matvec", h) for h in ("", header, other)}
    assert len(paths) == 3 and _build.library_path("kernel_matvec", header).name.startswith("kernel_matvec-covar-")
    # the sources compile the id only where the header defines it
    covar = (_build.CSRC / "covar.cuh").read_text()
    assert "#define COVAR_USER 5" in covar and "#ifdef LO_USER_COVAR" in covar
    for src in ("kernel_matvec", "kernel_matvec_sym", "kernel_weighted", "kernel_build_sym"):
        text = (_build.CSRC / f"{src}.cu").read_text()
        assert "#ifdef LO_USER_COVAR\n    case COVAR_USER:" in text, src


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117sym_matvec_kernelILi0ELi2ELi4EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117sym_matvec_kernelILi0ELi2ELi4EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 142 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117sym_matvec_kernelILi0ELi1ELi0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117sym_matvec_kernelILi0ELi1ELi0EEEvPKf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_report_reads_the_main_path_instantiation():
    mangled = _build.MAIN_PATH_KERNELS["kernel_matvec_sym"]
    assert _build.ptxas_report(_PTXAS_LOG, mangled) == (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; Used 142 registers, used 1 barriers"
    )
    assert _build.ptxas_report(_PTXAS_LOG, "matvec_kernelILi0ELi9ELi4E") == "not found"
    assert _build.ptxas_summary(_PTXAS_LOG) == "2 kernels, at most 168 registers, 1 spill"


@pytest.mark.parametrize(
    "src,variant", [(src, name) for src, names in kernel_variants.VARIANTS.items() for name in names]
)
def test_kernel_variant_still_applies(src, variant):
    # each text a variant replaces is in its source exactly once, so an edit
    # of K1 or K3 that moves one fails here rather than on the card
    assert kernel_variants.patched(src, variant) != (_build.CSRC / f"{src}.cu").read_text()


def test_kernel_variant_with_a_missing_text_raises(monkeypatch):
    monkeypatch.setitem(kernel_variants.VARIANTS["kernel_matvec"], "gone", [("no such text", "")])
    with pytest.raises(ValueError, match="exactly once"):
        kernel_variants.patched("kernel_matvec", "gone")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    # the card tests too: they run where JAX is not installed
    files = sorted((ROOT / "linear_operator_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "time_checkouts.py", ROOT / "tests" / "test_torch_cuda.py",
    ]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "linear_operator_tpu"), (path, name)

