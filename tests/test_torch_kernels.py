"""The port's fused kernel mat-vecs (K1, K3) against the JAX package.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the JAX side runs K1 in Pallas interpret mode (a 3-pass bf16 product, ~1e-5
relative to exact f32, hence K1's rtol 1e-4) and K3 through its dense f32
HIGHEST fallback (rtol 1e-5).  Errors are taken relative to the largest
entry of the result (``atol = rtol * max|ref|``): a sum of signed terms has
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
from linear_operator_tpu_torch.operators.kernel import rbf_kernel_operator
from linear_operator_tpu_torch.ops import rbf as trbf

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


def test_cpu_runs_plain_version_and_counts_no_launch():
    x, v = _data(4, (64, 3), (64, 5))
    before = (trbf.kernel_matvec.launches, trbf.kernel_matvec_sym.launches)
    a = trbf.kernel_matvec(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(v))
    b = trbf.kernel_matvec_sym(torch.from_numpy(x), torch.from_numpy(v))
    assert (trbf.kernel_matvec.launches, trbf.kernel_matvec_sym.launches) == before
    plain = trbf.kernel_matvec_plain(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(v))
    torch.testing.assert_close(a, plain, rtol=0, atol=0)
    torch.testing.assert_close(b, plain, rtol=0, atol=0)


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    x = torch.empty((8, 3), device="meta")
    v = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        trbf.kernel_matvec(x, x, v)
    with pytest.raises(ValueError, match="CUDA"):
        trbf.kernel_matvec_sym(torch.zeros(8, 3), v)


def test_backward_through_kernels_raises():
    x, v = _data(5, (32, 3), (32, 4))
    xt = torch.from_numpy(x).requires_grad_()
    for out in (
        trbf.kernel_matvec(xt, xt, torch.from_numpy(v)),
        trbf.kernel_matvec_sym(xt, torch.from_numpy(v)),
    ):
        with pytest.raises(NotImplementedError, match="next slice"):
            out.sum().backward()


def test_kernel_sources_hash_into_library_names():
    from linear_operator_tpu_torch import _build

    assert _build.sources() == ["kernel_matvec", "kernel_matvec_sym"]
    paths = {_build.library_path(name) for name in _build.sources()}
    assert len(paths) == 2 and all(p.parent == _build.BUILD_DIR for p in paths)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


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
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "linear_operator_tpu"), (path, name)

