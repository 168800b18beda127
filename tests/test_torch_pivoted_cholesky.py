"""The port's greedy pivoted Cholesky (strict and blocked) and the pointwise
``_get_indices`` it gathers columns with, against the JAX package.

Everything runs in float64 on identical numpy inputs.  Both packages do the
same arithmetic in the same pivot order, so the strict factor agrees to rtol
1e-10 of its largest entry with identical pivots, the blocked factor to 1e-10,
and gradients of sum(L) to 1e-8 of their norm.  Inputs are random points, not
grids: ``torch.topk`` and ``lax.top_k`` may order exact ties differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.functions import pivoted_cholesky as j_pivoted_cholesky
from linear_operator_tpu.operators import kernel as jkernel
from linear_operator_tpu.operators.dense import DenseLinearOperator as JaxDense
from linear_operator_tpu.solvers.pivoted_cholesky import _blocked_pivoted_cholesky as j_blocked
from linear_operator_tpu_torch.functions import pivoted_cholesky as t_pivoted_cholesky
from linear_operator_tpu_torch.operators import kernel as tkernel
from linear_operator_tpu_torch.operators.dense import DenseLinearOperator as TorchDense
from linear_operator_tpu_torch.solvers.pivoted_cholesky import _blocked_pivoted_cholesky as t_blocked
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol):
    """Entrywise, with errors taken relative to the largest entry."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _kernel_ops(seed, batched, n=300, d=3):
    """A JAX and a port RBF kernel operator on the same points; a batched
    one carries (2, 1, 1) hyperparameters, the batched parameter layout of
    both packages."""
    rng = np.random.default_rng(seed)
    shape = (2, n, d) if batched else (n, d)
    x = rng.normal(size=shape)
    ls = np.array([0.7, 1.1]).reshape(2, 1, 1) if batched else np.array(0.8)
    os_ = np.array([1.3, 0.6]).reshape(2, 1, 1) if batched else np.array(1.2)
    jop = jkernel.rbf_kernel_operator(jnp.asarray(x), lengthscale=jnp.asarray(ls), outputscale=jnp.asarray(os_))
    top = tkernel.rbf_kernel_operator(
        torch.from_numpy(x), lengthscale=torch.from_numpy(ls), outputscale=torch.from_numpy(os_),
        use_fused_kernels=False,
    )
    return jop, top


def _dense_ops(seed, batched, n=200):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, n, 40) if batched else (n, 40))
    k = a @ np.swapaxes(a, -1, -2) + 1e-3 * np.eye(n)
    return JaxDense(jnp.asarray(k)), TorchDense(torch.from_numpy(k))


OPS = {"kernel": _kernel_ops, "dense": _dense_ops}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["kernel", "dense"])
def test_strict_greedy_matches_jax(kind, batched):
    jop, top = OPS[kind](1, batched)
    jl, jp = j_pivoted_cholesky(jop, 25, return_pivots=True)
    tl, tp = t_pivoted_cholesky(top, 25, return_pivots=True)
    assert tl.shape == jl.shape and tp.shape == jp.shape
    np.testing.assert_array_equal(_np(tp), _np(jp))
    assert (_np(tp) >= 0).all()
    _close(tl, jl, 1e-10)


@pytest.mark.parametrize("kind, tol", [("kernel", 0.5), ("dense", 0.05)])
def test_error_tol_stops_early(kind, tol):
    # a loose tolerance: each element converges before rank 40, and the
    # remaining steps write zero columns and record pivot -1
    jop, top = OPS[kind](2, batched=True)
    jl, jp = j_pivoted_cholesky(jop, 40, error_tol=tol, return_pivots=True)
    tl, tp = t_pivoted_cholesky(top, 40, error_tol=tol, return_pivots=True)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    stopped = _np(tp) < 0
    assert stopped.any() and (~stopped).any()
    assert np.all(_np(tl)[np.broadcast_to(stopped[..., None, :], tl.shape)] == 0.0)
    _close(tl, jl, 1e-10)


def test_return_pivots_and_operator_method():
    jop, top = _kernel_ops(3, batched=False)
    L = top.pivoted_cholesky(10)
    L2, piv = top.pivoted_cholesky(10, return_pivots=True)
    jl, jp = jop.pivoted_cholesky(10, return_pivots=True)
    assert isinstance(L, torch.Tensor) and L.shape == (300, 10)
    assert piv.dtype == torch.int32 and piv.shape == (10,)
    np.testing.assert_array_equal(_np(piv), _np(jp))
    _close(L, L2, 0)
    _close(L, jl, 1e-10)
    # rank above n clips to n
    jop, top = _dense_ops(4, batched=False, n=12)
    assert t_pivoted_cholesky(top, 20).shape == j_pivoted_cholesky(jop, 20).shape == (12, 12)


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("kind", ["kernel", "dense"])
def test_blocked_matches_jax(kind, bs):
    jop, top = OPS[kind](5, batched=False)
    _close(t_blocked(top, 30, None, bs), j_blocked(jop, 30, None, bs), 1e-10)


def test_blocked_through_settings_and_batched_fallback():
    jop, top = _kernel_ops(6, batched=False)
    with jlo.settings.pivoted_cholesky_block_size(6), tlo.settings.pivoted_cholesky_block_size(6):
        got, want = t_pivoted_cholesky(top, 24), j_pivoted_cholesky(jop, 24)
        # pivots requested: the strict variant, whatever the block size
        _, tp = t_pivoted_cholesky(top, 24, return_pivots=True)
        _, jp = j_pivoted_cholesky(jop, 24, return_pivots=True)
        # batched operators fall back to strict greedy
        jb, tb = _kernel_ops(7, batched=True)
        _close(t_pivoted_cholesky(tb, 12), j_pivoted_cholesky(jb, 12), 1e-10)
    _close(got, want, 1e-10)
    np.testing.assert_array_equal(_np(tp), _np(jp))


def test_blocked_backward_raises():
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(200, 3)))
    ls = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    op = tkernel.rbf_kernel_operator(x, lengthscale=ls, outputscale=1.0, use_fused_kernels=False)
    with tlo.settings.pivoted_cholesky_block_size(4):
        L = t_pivoted_cholesky(op, 12)
    assert L.requires_grad
    with pytest.raises(NotImplementedError, match="forward-only"):
        L.sum().backward()
    # without a tensor that needs a gradient the factor is a plain tensor
    with tlo.settings.pivoted_cholesky_block_size(4):
        assert not t_pivoted_cholesky(op.detach(), 12).requires_grad


@pytest.mark.parametrize("batched", [False, True])
def test_strict_gradient_matches_jax(batched):
    """d sum(L) / d (x, lengthscale, outputscale), the pivots held constant,
    against jax.grad."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 150, 3) if batched else (150, 3))
    hyper = (np.array([0.8, 1.1]).reshape(2, 1, 1), np.array([1.3, 0.7]).reshape(2, 1, 1)) if batched else (0.8, 1.3)

    def jf(x_, ls, os_):
        op = jkernel.rbf_kernel_operator(x_, lengthscale=ls, outputscale=os_)
        return jnp.sum(j_pivoted_cholesky(op, 12))

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), *(jnp.asarray(h) for h in hyper))
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.tensor(h, dtype=torch.float64, requires_grad=True) for h in hyper
    ]
    op = tkernel.rbf_kernel_operator(leaves[0], lengthscale=leaves[1], outputscale=leaves[2], use_fused_kernels=False)
    t_pivoted_cholesky(op, 12).sum().backward()
    for t, w in zip(leaves, want):
        w = _np(w)
        np.testing.assert_allclose(_np(t.grad), w, rtol=1e-8, atol=1e-8 * np.linalg.norm(w))


@pytest.mark.parametrize("batched", [False, True])
def test_kernel_get_indices_matches_jax(batched):
    jop, top = _kernel_ops(10, batched)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 300, size=(2, 7) if batched else (7,))
    cols = rng.integers(0, 300, size=rows.shape)
    bidx = [np.broadcast_to(np.arange(2)[:, None], rows.shape)] if batched else []
    want = jop._get_indices(*(jnp.asarray(a) for a in (rows, cols, *bidx)))
    got = top._get_indices(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (rows, cols, *bidx)))
    assert got.shape == rows.shape
    _close(got, want, 1e-12)
    # and against the dense matrix
    _close(got, _np(top.to_dense())[(*bidx, rows, cols)], 1e-12)


def test_default_preconditioner_is_pivoted():
    """AddedDiag's default mode builds the rank-15 pivoted factor of its
    kernel term, as the JAX package's does."""
    jop, top = _kernel_ops(12, batched=False)
    jk = jop.add_diagonal(jnp.asarray(0.1))
    tk = top.add_diagonal(torch.tensor(0.1, dtype=torch.float64))
    assert tlo.settings.preconditioner_mode.value() == "pivoted"
    _close(tk._build_precond_factor(), jk._build_precond_factor(), 1e-10)
    assert tk._build_precond_factor().shape == (300, 15)
