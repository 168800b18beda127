"""The port's CUDA kernels (K1, K3) against their plain PyTorch versions, on
the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; there, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX.)  Errors are taken
relative to the largest entry of the plain result: both sides are f32 sums
of up to n terms in different orders, so they agree to ~sqrt(n) eps of that
scale; rtol 1e-4 leaves a wide margin and a wrong kernel misses it by orders.
"""

import numpy as np
import pytest
import torch

from linear_operator_tpu_torch.operators.kernel import rbf_kernel_operator
from linear_operator_tpu_torch.ops import rbf

COVARS = ["rbf", "matern52", "matern32", "matern12", "rq"]
RTOL = 1e-4


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


def _close(got, want):
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= RTOL * float(want.abs().max()), err


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
