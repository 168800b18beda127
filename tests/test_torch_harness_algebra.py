"""The port's property suite on the operator algebra: identity, zero,
constant and Hadamard products, lazy products, batch repeat and sum, block
interleaving, concatenation, permutations and masks (mirrors
tests/operators/test_misc_ops.py and test_harness_coverage.py), each class
also held against the JAX package."""

import jax.numpy as jnp
import numpy as np
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu_torch.test import LinearOperatorTestCase, RectangularLinearOperatorTestCase
from test_torch_harness_common import JaxParity, jx, normal, positive, psd, one_torch_thread  # noqa: F401 (an autouse fixture)


class TestIdentityLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 0
    should_call_cg = False
    should_call_lanczos = False

    def create_linear_op(self):
        return tlo.IdentityLinearOperator(6, dtype=torch.float64, device=self.device)

    def create_jax_op(self):
        return jlo.IdentityLinearOperator(diag_shape=6, dtype_="float64")

    def evaluate_linear_op(self, op):
        return torch.eye(op.diag_shape, dtype=torch.float64, device=self.device)

    def test_exp_log_abs(self):
        # exp is e I, the elementwise exp of the diagonal; log(1) = 0
        op = self.create_linear_op()
        eye = torch.eye(6, dtype=torch.float64, device=self.device)
        self.assertAllClose(op.exp().to_dense(), np.e * eye, rtol=1e-15, atol=0)
        self.assertAllClose(op.log().to_dense(), torch.zeros(6, 6), rtol=0, atol=0)
        self.assertIs(op.abs(), op)
        self.assertIs(op.sqrt(), op)


class TestConstantMulLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 1
    a = psd(60)
    c = np.asarray(2.5)

    def create_linear_op(self):
        return tlo.ConstantMulLinearOperator(tlo.DenseLinearOperator(self.tensor(self.a)), self.tensor(self.c))

    def create_jax_op(self):
        return jlo.ConstantMulLinearOperator(jlo.DenseLinearOperator(jx(self.a)), jx(self.c))

    def evaluate_linear_op(self, op):
        c = op.constant
        return op.base.tensor * (c[..., None, None] if c.ndim else c)


class TestConstantMulLinearOperatorBatchConstant(TestConstantMulLinearOperator):
    seed = 2
    should_test_sample = False
    c = positive(61, 3, shift=0.5)
    a = psd(62, 3)


class TestMatmulLinearOperator(JaxParity, RectangularLinearOperatorTestCase):
    seed = 3
    a, b = normal(63, 6, 4), normal(64, 4, 5)

    def create_linear_op(self):
        return tlo.MatmulLinearOperator(tlo.DenseLinearOperator(self.tensor(self.a)), tlo.DenseLinearOperator(self.tensor(self.b)))

    def create_jax_op(self):
        return jlo.MatmulLinearOperator(jlo.DenseLinearOperator(jx(self.a)), jlo.DenseLinearOperator(jx(self.b)))

    def evaluate_linear_op(self, op):
        return op.left.tensor @ op.right.tensor

    def test_diagonal_square(self):
        a, b = self.tensor(normal(65, 5, 5)), self.tensor(normal(66, 5, 5))
        op = tlo.MatmulLinearOperator(tlo.DenseLinearOperator(a), tlo.DenseLinearOperator(b))
        self.assertAllClose(op.diagonal(), torch.diagonal(a @ b), rtol=1e-9, atol=1e-9)


class TestMulLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 4
    should_call_cg = False  # Hadamard products solve by dense paths
    la = normal(67, 6, 6) + 3 * np.eye(6)
    lb = normal(68, 6, 6) + 3 * np.eye(6)

    def create_linear_op(self):
        return tlo.MulLinearOperator(tlo.DenseLinearOperator(self.tensor(self.la)), tlo.DenseLinearOperator(self.tensor(self.lb)))

    def create_jax_op(self):
        return jlo.MulLinearOperator(jlo.DenseLinearOperator(jx(self.la)), jlo.DenseLinearOperator(jx(self.lb)))

    def evaluate_linear_op(self, op):
        la, lb = op.left_root.tensor, op.right_root.tensor
        return (la @ la.mT) * (lb @ lb.mT)

    def test_from_operators(self):
        a = tlo.RootLinearOperator(tlo.DenseLinearOperator(self.tensor(normal(69, 6, 6) + 3 * np.eye(6))))
        b = tlo.RootLinearOperator(tlo.DenseLinearOperator(self.tensor(normal(70, 6, 6) + 3 * np.eye(6))))
        op = a * b
        self.assertIsInstance(op, tlo.MulLinearOperator)
        self.assertAllClose(op.to_dense(), a.to_dense() * b.to_dense(), rtol=1e-9, atol=1e-9)


class TestBatchRepeatLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 5
    should_test_sample = False
    a = psd(71, 2)

    def create_linear_op(self):
        return tlo.BatchRepeatLinearOperator(tlo.DenseLinearOperator(self.tensor(self.a)), batch_repeat=(3, 1))

    def create_jax_op(self):
        return jlo.BatchRepeatLinearOperator(jlo.DenseLinearOperator(jx(self.a)), batch_repeat=(3, 1))

    def evaluate_linear_op(self, op):
        return op.base.tensor.repeat(3, 1, 1, 1)


class TestSumBatchLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 6
    a = psd(72, 4)

    def create_linear_op(self):
        return tlo.SumBatchLinearOperator(tlo.DenseLinearOperator(self.tensor(self.a)))

    def create_jax_op(self):
        return jlo.SumBatchLinearOperator(jlo.DenseLinearOperator(jx(self.a)))

    def evaluate_linear_op(self, op):
        return torch.sum(op.base.tensor, dim=0)

    def test_getitem_tensor_index(self):
        pass  # the base's _get_indices through SumBatch is held separately


class TestCatLinearOperatorPSD(JaxParity, LinearOperatorTestCase):
    seed = 1
    full = psd(20, n=7)

    def _blocks(self, wrap, conv):
        f = self.full
        k11, k12, k21, k22 = (wrap(conv(b)) for b in (f[:4, :4], f[:4, 4:], f[4:, :4], f[4:, 4:]))
        return (k11, k12), (k21, k22)

    def create_linear_op(self):
        top, bottom = self._blocks(tlo.DenseLinearOperator, self.tensor)
        return tlo.CatLinearOperator(
            (tlo.CatLinearOperator(top, cat_dim=-1), tlo.CatLinearOperator(bottom, cat_dim=-1)), cat_dim=-2
        )

    def create_jax_op(self):
        top, bottom = self._blocks(jlo.DenseLinearOperator, jx)
        return jlo.CatLinearOperator(
            (jlo.CatLinearOperator(top, cat_dim=-1), jlo.CatLinearOperator(bottom, cat_dim=-1)), cat_dim=-2
        )

    def evaluate_linear_op(self, op):
        top, bottom = op.operators
        return torch.cat(
            [torch.cat([b.to_dense() for b in top.operators], dim=-1), torch.cat([b.to_dense() for b in bottom.operators], dim=-1)],
            dim=-2,
        )


class TestCatLinearOperatorRows(JaxParity, RectangularLinearOperatorTestCase):
    seed = 2
    a, b = normal(21, 3, 6), normal(22, 4, 6)

    def create_linear_op(self):
        return tlo.CatLinearOperator((tlo.DenseLinearOperator(self.tensor(self.a)), tlo.DenseLinearOperator(self.tensor(self.b))))

    def create_jax_op(self):
        return jlo.CatLinearOperator((jlo.DenseLinearOperator(jx(self.a)), jlo.DenseLinearOperator(jx(self.b))), cat_dim=-2)

    def evaluate_linear_op(self, op):
        return torch.cat([o.to_dense() for o in op.operators], dim=-2)


class TestCatLinearOperatorBatchRows(JaxParity, RectangularLinearOperatorTestCase):
    """Batched blocks stacked by rows: the diagonal reads each block's
    stretch through its batch indices."""

    seed = 3
    a, b = normal(23, 2, 3, 6), normal(24, 2, 4, 6)

    def create_linear_op(self):
        return tlo.CatLinearOperator((tlo.DenseLinearOperator(self.tensor(self.a)), tlo.DenseLinearOperator(self.tensor(self.b))))

    def create_jax_op(self):
        return jlo.CatLinearOperator((jlo.DenseLinearOperator(jx(self.a)), jlo.DenseLinearOperator(jx(self.b))), cat_dim=-2)

    def evaluate_linear_op(self, op):
        return torch.cat([o.to_dense() for o in op.operators], dim=-2)


class TestCatLinearOperatorBatchColumns(JaxParity, LinearOperatorTestCase):
    """A batch of PSD matrices split into three column blocks."""

    seed = 4
    full = psd(25, 2, n=7)

    def _blocks(self, wrap, conv):
        f = self.full
        return tuple(wrap(conv(f[..., :, lo:hi])) for lo, hi in ((0, 2), (2, 5), (5, 7)))

    def create_linear_op(self):
        return tlo.CatLinearOperator(self._blocks(tlo.DenseLinearOperator, self.tensor), cat_dim=-1)

    def create_jax_op(self):
        return jlo.CatLinearOperator(self._blocks(jlo.DenseLinearOperator, jx), cat_dim=-1)

    def evaluate_linear_op(self, op):
        return torch.cat([o.to_dense() for o in op.operators], dim=-1)


class TestPermutationLinearOperator(JaxParity, RectangularLinearOperatorTestCase):
    seed = 3
    perm = np.array([3, 0, 4, 1, 2])

    def create_linear_op(self):
        return tlo.PermutationLinearOperator(self.tensor(self.perm))

    def create_jax_op(self):
        return jlo.PermutationLinearOperator(jx(self.perm).astype(jnp.int32)).astype(jnp.float64)

    def evaluate_linear_op(self, op):
        n = op.shape[-1]
        return torch.eye(n, dtype=op.dtype, device=self.device)[op.perm]


class TestTransposePermutationLinearOperator(JaxParity, RectangularLinearOperatorTestCase):
    """The vec-transpose permutation of 2 x 2 matrices, a symmetric
    involution."""

    seed = 4

    def create_linear_op(self):
        return tlo.TransposePermutationLinearOperator.from_side(2, device=self.device)

    def create_jax_op(self):
        return jlo.TransposePermutationLinearOperator.from_side(2)

    def evaluate_linear_op(self, op):
        n = op.shape[-1]
        return torch.eye(n, dtype=op.dtype, device=self.device)[op.perm]

    def test_matches_jax(self):
        op, jop = self.create_linear_op(), self.create_jax_op()
        self.assertAllClose(op.to_dense(), jop.to_dense(), rtol=0, atol=0)
        self.assertAllClose(op.perm, jop.perm, rtol=0, atol=0)


class TestBlockInterleavedLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 5
    blocks = psd(30, 3, n=4)

    def create_linear_op(self):
        return tlo.BlockInterleavedLinearOperator(tlo.DenseLinearOperator(self.tensor(self.blocks)))

    def create_jax_op(self):
        return jlo.BlockInterleavedLinearOperator(jlo.DenseLinearOperator(jx(self.blocks)))

    def evaluate_linear_op(self, op):
        blocks = op.base.to_dense()  # (k, n, n)
        k, n = blocks.shape[-3], blocks.shape[-1]
        dense = torch.zeros((k * n, k * n), dtype=blocks.dtype, device=self.device)
        for b in range(k):
            dense[b::k, b::k] = blocks[b]
        return dense


class TestZeroLinearOperator(JaxParity, RectangularLinearOperatorTestCase):
    seed = 8

    def create_linear_op(self):
        return tlo.ZeroLinearOperator((5, 4), dtype=torch.float64, device=self.device)

    def create_jax_op(self):
        return jlo.ZeroLinearOperator(shape_=(5, 4), dtype_="float64")

    def evaluate_linear_op(self, op):
        return torch.zeros((5, 4), dtype=torch.float64, device=self.device)


class TestMaskedLinearOperatorPSD(JaxParity, LinearOperatorTestCase):
    seed = 9
    a = psd(60, n=9)
    idx = np.array([0, 2, 3, 5, 7, 8])

    def create_linear_op(self):
        idx = self.tensor(self.idx)
        return tlo.MaskedLinearOperator(tlo.DenseLinearOperator(self.tensor(self.a)), idx, idx)

    def create_jax_op(self):
        idx = jx(self.idx).astype(jnp.int32)
        return jlo.MaskedLinearOperator(jlo.DenseLinearOperator(jx(self.a)), idx, idx)

    def evaluate_linear_op(self, op):
        return op.base.tensor[op.row_idx][:, op.col_idx]
