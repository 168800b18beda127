"""Helpers of the port's harness files (``test_torch_harness_*.py``), which
run the port's shipped property suite (``linear_operator_tpu_torch.test``)
on each port operator, at the sizes and data of the JAX package's own
harness classes (``tests/operators/``).

The data are numpy draws from a fixed seed; each class builds the port's
operator on the case's device and, in ``create_jax_op``, the JAX package's
from the same arrays.  ``JaxParity.test_matches_jax`` holds the two against
each other in float64: the dense matrix, a mat-vec and (square operators) a
solve, to 1e-10 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch


TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, and one thread in numpy's BLAS and LAPACK, while a
    module of these runs.  The tests make thousands of tiny operations;
    under pytest-xdist each worker's torch (and numpy's OpenBLAS, which the
    reference computations call) would start a thread for every core, and
    the workers' spinning threads slow each other tenfold (two workers: 330
    s instead of 30 s; a batched 300 x 300 slogdet beside five busy workers
    8.2 s instead of 1.7 s).  Imported into each module that uses it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(threads)


def _jit(fn):
    """``fn`` jitted with XLA's backend (LLVM) optimizations off: the same
    operations, compiled in less time (compiling, not running, is what the
    JAX references cost at these sizes).  Positional arguments only."""

    def call(*args):
        return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)

    return call


def rng(seed):
    return np.random.default_rng(seed)


def psd(seed, *batch, n=6):
    a = rng(seed).normal(size=(*batch, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def normal(seed, *shape):
    return rng(seed).normal(size=shape)


def positive(seed, *shape, shift=1.0):
    return np.abs(rng(seed).normal(size=shape)) + shift


def jx(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=jnp.float64) if a.dtype.kind == "f" else jnp.asarray(a)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(actual, expected, tol=TOL, what=""):
    a, e = _np(actual), _np(expected)
    assert a.shape == e.shape, f"{what}: shape {a.shape} vs {e.shape}"
    scale = max(float(np.max(np.abs(e))), 1e-300) if e.size else 1.0
    err = float(np.max(np.abs(a - e))) if a.size else 0.0
    assert err <= tol * scale, f"{what}: max abs error {err:.3e} > {tol:.0e} x {scale:.3e}"


class JaxParity:
    """Holds the port's operator against the JAX package's, built from the
    same arrays (``create_jax_op``)."""

    parity_solve = None  # None: solve when the operator is square
    # the JAX kernel operator contracts its blocks at Precision.HIGH, which
    # on the CPU rounds a float64 product to ~1e-7: its mat-vec is then held
    # through the JAX operator's dense matrix
    parity_matmul_via_dense = False

    def create_jax_op(self):
        raise NotImplementedError

    def test_matches_jax(self):
        op = self.create_linear_op()
        solve = op.is_square if self.parity_solve is None else self.parity_solve
        rhs = normal(7, *op.batch_shape, op.shape[-1], 2)
        b = normal(8, *op.batch_shape, op.shape[-1], 2)
        via_dense = self.parity_matmul_via_dense

        def reference(jop, rhs, b):
            dense = jop.to_dense()
            return dense, (dense @ rhs if via_dense else jop @ rhs), (jop.solve(b) if solve else None)

        # one jitted call with XLA's backend optimizations off: the eager
        # JAX operations would compile each primitive at each shape
        want = jax.jit(reference).lower(self.create_jax_op(), jx(rhs), jx(b)).compile(
            {"xla_backend_optimization_level": 0}
        )(self.create_jax_op(), jx(rhs), jx(b))
        close(op.to_dense(), want[0], what="to_dense")
        close(op @ self.tensor(rhs), want[1], what="matmul")
        if solve:
            close(op.solve(self.tensor(b)), want[2], what="solve")
