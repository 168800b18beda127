"""The port's property suite on the structured operators: Kronecker products,
Toeplitz, block-diagonal, masked, interpolated and grid-interpolated
(mirrors tests/operators/test_kronecker.py, test_structured.py,
test_grid_interpolated.py and test_harness_coverage.py's Interpolated,
SumKronecker and KroneckerProductAddedDiag classes), each class also held
against the JAX package."""

import jax.numpy as jnp
import numpy as np
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.operators.grid_interpolated import GridInterpolatedLinearOperator as JGrid
from linear_operator_tpu_torch.test import LinearOperatorTestCase, RectangularLinearOperatorTestCase
from test_torch_harness_common import JaxParity, jx, normal, positive, psd, one_torch_thread  # noqa: F401 (an autouse fixture)


def _kron(a, b):
    if a.ndim == 2:
        return torch.kron(a, b)
    return torch.stack([torch.kron(x, y) for x, y in zip(a, b)])


class TestKroneckerProduct(JaxParity, LinearOperatorTestCase):
    seed = 0
    should_test_sample = False
    a, b = psd(90, n=3), psd(91, n=4)

    def create_linear_op(self):
        return tlo.KroneckerProductLinearOperator(
            tlo.DenseLinearOperator(self.tensor(self.a)), tlo.DenseLinearOperator(self.tensor(self.b))
        )

    def create_jax_op(self):
        return jlo.KroneckerProductLinearOperator((jlo.DenseLinearOperator(jx(self.a)), jlo.DenseLinearOperator(jx(self.b))))

    def evaluate_linear_op(self, op):
        return _kron(op.operators[0].tensor, op.operators[1].tensor)


class TestKroneckerProductBatch(TestKroneckerProduct):
    seed = 1
    a, b = psd(92, 2, n=3), psd(93, 2, n=2)


def _toeplitz_dense(col):
    n = col.shape[-1]
    i = torch.arange(n, device=col.device)
    return col[..., (i[:, None] - i[None, :]).abs()]


def _spd_toeplitz_column(n):
    # exponentially decaying: strictly diagonally dominant, so SPD
    return 2.0 ** (-np.arange(n, dtype=np.float64)) + (np.arange(n) == 0)


class TestToeplitzLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 0
    col = _spd_toeplitz_column(8)

    def create_linear_op(self):
        return tlo.ToeplitzLinearOperator(self.tensor(self.col))

    def create_jax_op(self):
        return jlo.ToeplitzLinearOperator(jx(self.col))

    def evaluate_linear_op(self, op):
        return _toeplitz_dense(op.column)


class TestToeplitzLinearOperatorBatch(TestToeplitzLinearOperator):
    seed = 1
    should_test_sample = False
    col = _spd_toeplitz_column(6) * np.array([1.0, 1.5, 2.0])[:, None]


class TestBlockDiag(JaxParity, LinearOperatorTestCase):
    seed = 2
    should_test_sample = False
    blocks = psd(110, 3, n=4)

    def create_linear_op(self):
        return tlo.BlockDiagLinearOperator(tlo.DenseLinearOperator(self.tensor(self.blocks)))

    def create_jax_op(self):
        return jlo.BlockDiagLinearOperator(jlo.DenseLinearOperator(jx(self.blocks)))

    def evaluate_linear_op(self, op):
        return torch.block_diag(*op.base.tensor)


class TestMasked(JaxParity, RectangularLinearOperatorTestCase):
    seed = 3
    should_test_getitem_tensor_index = False
    parity_solve = False  # a square selection, not symmetric
    a = psd(116, n=8)
    row_mask = np.array([1, 0, 1, 1, 0, 1, 1, 0], bool)
    col_mask = np.array([1, 1, 0, 1, 0, 1, 0, 1], bool)

    def create_linear_op(self):
        return tlo.MaskedLinearOperator.from_masks(tlo.DenseLinearOperator(self.tensor(self.a)), self.row_mask, self.col_mask)

    def create_jax_op(self):
        return jlo.MaskedLinearOperator.from_masks(jlo.DenseLinearOperator(jx(self.a)), self.row_mask, self.col_mask)

    def evaluate_linear_op(self, op):
        return op.base.tensor[op.row_idx][:, op.col_idx]


def _interp_dense(indices, values, grid):
    """The dense (*b, rows, grid) interpolation matrix (repeated indices
    add), differentiable in the values."""
    out = torch.zeros((*indices.shape[:-1], grid), dtype=values.dtype, device=values.device)
    return out.scatter_add(-1, indices, values)


class TestInterpolatedLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 0
    grid, n = 8, 6
    base = psd(10, n=8)
    li = np.array([[0, 1], [1, 2], [2, 3], [4, 5], [5, 6], [6, 7]])
    lv = positive(11, 6, 2, shift=0.5)

    def create_linear_op(self):
        li, lv = self.tensor(self.li), self.tensor(self.lv)
        op = tlo.InterpolatedLinearOperator(tlo.DenseLinearOperator(self.tensor(self.base)), li, lv, li, lv)
        return op.add_jitter(1.0)

    def create_jax_op(self):
        li, lv = jx(self.li).astype(jnp.int32), jx(self.lv)
        return jlo.InterpolatedLinearOperator(jlo.DenseLinearOperator(jx(self.base)), li, lv, li, lv).add_jitter(1.0)

    def evaluate_linear_op(self, op):
        interp = op.operators[0]
        wl = _interp_dense(interp.left_indices, interp.left_values, self.grid)
        wr = _interp_dense(interp.right_indices, interp.right_values, self.grid)
        return wl @ interp.base.to_dense() @ wr.mT + torch.diag_embed(op.operators[1]._diagonal())


def _batch_interp_indices():
    li = np.random.default_rng(31).integers(0, 7, size=(3, 6, 1))
    return np.concatenate([li, li + 1], axis=-1)


class TestInterpolatedLinearOperatorBatch(TestInterpolatedLinearOperator):
    """Batched interpolation tensors and a batched base.

    Its SLQ gradient check is Monte Carlo: the gradient in the interpolation
    values has a large variance beside its size here, and at the suite's
    4096 probes its error over seeds 0-19 has a median of 0.24 of the
    largest entry and reaches 0.69; 9 seeds of 20, the JAX class's seed 3
    among them, fall outside the envelope.  At 65,536 probes the median is
    0.057 and the worst 0.20, none outside (``slq_gradient_spread`` below)."""

    seed = 3
    slq_grad_trace_samples = 65_536
    base = psd(30, 3, n=8)
    li = _batch_interp_indices()
    lv = positive(32, 3, 6, 2, shift=0.5)


class TestSumKroneckerLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 6
    mats = [psd(40, n=3), psd(41, n=2), psd(42, n=3), psd(43, n=2)]

    def create_linear_op(self):
        A, B, C, D = (tlo.DenseLinearOperator(self.tensor(m)) for m in self.mats)
        return tlo.SumKroneckerLinearOperator(
            (tlo.KroneckerProductLinearOperator(A, B), tlo.KroneckerProductLinearOperator(C, D))
        )

    def create_jax_op(self):
        A, B, C, D = (jlo.DenseLinearOperator(jx(m)) for m in self.mats)
        return jlo.SumKroneckerLinearOperator(
            (jlo.KroneckerProductLinearOperator((A, B)), jlo.KroneckerProductLinearOperator((C, D)))
        )

    def evaluate_linear_op(self, op):
        kp1, kp2 = op.operators
        return _kron(kp1.operators[0].tensor, kp1.operators[1].tensor) + _kron(
            kp2.operators[0].tensor, kp2.operators[1].tensor
        )


class TestKroneckerProductAddedDiagLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 7
    k1, k2 = psd(50, n=3), psd(51, n=3)
    d = positive(52, 9, shift=0.5)

    def create_linear_op(self):
        kron = tlo.KroneckerProductLinearOperator(
            tlo.DenseLinearOperator(self.tensor(self.k1)), tlo.DenseLinearOperator(self.tensor(self.k2))
        )
        return tlo.KroneckerProductAddedDiagLinearOperator(kron, tlo.DiagLinearOperator(self.tensor(self.d)))

    def create_jax_op(self):
        kron = jlo.KroneckerProductLinearOperator((jlo.DenseLinearOperator(jx(self.k1)), jlo.DenseLinearOperator(jx(self.k2))))
        return jlo.KroneckerProductAddedDiagLinearOperator(kron, jlo.DiagLinearOperator(jx(self.d)))

    def evaluate_linear_op(self, op):
        kron = op.operators[0]
        k = _kron(kron.operators[0].tensor, kron.operators[1].tensor)
        return k + torch.diag_embed(op.operators[1]._diagonal())


class TestGridInterpolatedHarness(JaxParity, LinearOperatorTestCase):
    """W K W^T plus jitter on a 2-D grid."""

    seed = 0
    sizes, n, M = (4, 5), 6, 20
    a = normal(30, 20, 20)
    base = a @ a.T + 20 * np.eye(20)
    li = (
        np.array([[0, 1], [1, 2], [2, 3], [0, 2], [1, 3], [2, 0]]),
        np.array([[0, 1], [1, 2], [2, 3], [3, 4], [0, 3], [4, 1]]),
    )
    lv = tuple(positive(31 + d, 6, 2, shift=0.5) for d in range(2))

    def create_linear_op(self):
        li = tuple(self.tensor(i) for i in self.li)
        lv = tuple(self.tensor(v) for v in self.lv)
        base = tlo.DenseLinearOperator(self.tensor(self.base))
        return tlo.GridInterpolatedLinearOperator(base, li, lv, li, lv, self.sizes).add_jitter(1.0)

    def create_jax_op(self):
        li = tuple(jx(i).astype(jnp.int32) for i in self.li)
        lv = tuple(jx(v) for v in self.lv)
        return JGrid(jlo.DenseLinearOperator(jx(self.base)), li, lv, li, lv, self.sizes).add_jitter(1.0)

    def evaluate_linear_op(self, op):
        # the port flattens the stencils at construction: its tensors are
        # the flat (n, 4) rows
        interp = op.operators[0]
        wl = _interp_dense(interp.left_indices, interp.left_values, self.M)
        wr = _interp_dense(interp.right_indices, interp.right_values, self.M)
        return wl @ interp.base.to_dense() @ wr.mT + torch.diag_embed(op.operators[1]._diagonal())


def slq_gradient_spread(case, seeds, probes):
    """The largest error of ``case``'s SLQ gradient check at each seed, as a
    share of each leaf's largest expected entry, with ``probes`` probes and
    the check's other settings; and the seeds outside its envelope."""
    from linear_operator_tpu_torch import settings

    errors, outside = [], []
    for seed in seeds:
        test = type(f"{case.__name__}Seed{seed}", (case,), {"seed": seed})("test_inv_quad_logdet_stochastic_grad")
        test.setUp()
        op = test.create_linear_op()
        b = test._rand_rhs(op, ncols=3, batch=op.batch_shape)
        probe_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=test.generator))
        with settings.max_cholesky_size(0), settings.cg_tolerance(1e-10), settings.max_cg_iterations(2000), \
                settings.num_trace_samples(probes), settings.max_lanczos_quadrature_iterations(min(64, op.shape[-1])):
            got = test._leaf_grads(op, lambda o: (lambda r: torch.sum(r[0] + r[1]))(
                o.inv_quad_logdet(b, logdet=True, generator=torch.Generator().manual_seed(probe_seed))))
            want = test._leaf_grads(op, lambda o: (lambda d: torch.sum(test._iq_true(d, b) + torch.linalg.slogdet(d)[1]))(
                test.evaluate_linear_op(o)))
        tol = test.tolerances["logdet_grad"]
        err, out = 0.0, False
        for g, w in zip(got, want):
            if g is None:
                continue
            scale = torch.clamp(w.abs().max(), min=1e-12)
            diff = (g - w).abs() / scale
            err = max(err, float(diff.max()))
            out |= bool((diff > tol["atol"] + tol["rtol"] * (w / scale).abs()).any())
        errors.append(err)
        if out:
            outside.append(seed)
    return errors, outside


if __name__ == "__main__":
    # The spread of TestInterpolatedLinearOperatorBatch's SLQ gradient check
    # over seeds:  PYTHONPATH=. python tests/test_torch_harness_structured.py [SEEDS] [PROBES ...]
    import sys

    torch.set_num_threads(1)
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    for m in [int(a) for a in sys.argv[2:]] or [4096, TestInterpolatedLinearOperatorBatch.slq_grad_trace_samples]:
        errs, outside = slq_gradient_spread(TestInterpolatedLinearOperatorBatch, range(n_seeds), m)
        print(f"probes {m}: seeds 0-{n_seeds - 1}, largest error {max(errs):.3f}, median "
              f"{float(np.median(errs)):.3f}, seed 3 {errs[3] if n_seeds > 3 else float('nan'):.3f}; "
              f"outside the envelope at {len(outside)} seeds {outside}", flush=True)
