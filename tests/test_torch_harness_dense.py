"""The port's property suite on the dense, diagonal and triangular operators
(mirrors tests/operators/test_dense.py, test_diag.py and
test_triangular.py), each class also held against the JAX package."""

import numpy as np
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu_torch.test import LinearOperatorTestCase, RectangularLinearOperatorTestCase
from linear_operator_tpu_torch.utils.errors import NotPSDError
from test_torch_harness_common import JaxParity, jx, normal, positive, psd, one_torch_thread  # noqa: F401 (an autouse fixture)


class TestDenseLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 0
    a = psd(10, n=8)

    def create_linear_op(self):
        return tlo.DenseLinearOperator(self.tensor(self.a))

    def create_jax_op(self):
        return jlo.DenseLinearOperator(jx(self.a))

    def evaluate_linear_op(self, op):
        return op.tensor


class TestDenseLinearOperatorBatch(TestDenseLinearOperator):
    seed = 1
    a = psd(11, 3, n=8)


class TestDenseLinearOperatorMultiBatch(TestDenseLinearOperator):
    seed = 2
    should_test_sample = False
    a = psd(12, 2, 3, n=6)


class TestDenseLinearOperatorRectangular(JaxParity, RectangularLinearOperatorTestCase):
    seed = 3
    a = normal(13, 7, 5)

    def create_linear_op(self):
        return tlo.DenseLinearOperator(self.tensor(self.a))

    def create_jax_op(self):
        return jlo.DenseLinearOperator(jx(self.a))

    def evaluate_linear_op(self, op):
        return op.tensor


class _Diag(JaxParity, LinearOperatorTestCase):
    should_call_cg = False
    should_call_lanczos = False

    def create_linear_op(self):
        return tlo.DiagLinearOperator(self.tensor(self.d))

    def create_jax_op(self):
        return jlo.DiagLinearOperator(jx(self.d))

    def evaluate_linear_op(self, op):
        return torch.diag_embed(op.diag)


_Diag.__test__ = False  # a base: its subclasses hold the data


class TestDiagLinearOperator(_Diag):
    seed = 0
    d = positive(20, 8)


class TestDiagLinearOperatorBatch(_Diag):
    seed = 1
    d = positive(21, 2, 3, 6)

    def test_zero_mean_mvn_samples(self):
        pass  # batched


class TestDiagSolveTriangular(_Diag):
    """A diagonal operator solves triangular systems of either orientation;
    ``unitriangular`` treats the diagonal as ones and refuses one that is
    not."""

    seed = 3
    d = positive(23, 5)

    def test_solve_triangular(self):
        op = self.create_linear_op()
        rhs = self.tensor(normal(30, 5))
        for upper in (False, True):
            self.assertAllClose(op.solve_triangular(rhs, upper=upper), rhs / op.diagonal(), rtol=1e-14, atol=0)
        mat = self.tensor(normal(31, 5, 2))
        self.assertAllClose(op.solve_triangular(mat, upper=False), mat / op.diagonal()[:, None], rtol=1e-14, atol=0)
        matr = self.tensor(normal(32, 2, 5))
        self.assertAllClose(
            op.solve_triangular(matr, upper=False, left=False), matr / op.diagonal()[None, :], rtol=1e-14, atol=0
        )
        with self.assertRaises(RuntimeError):
            op.solve_triangular(rhs, upper=False, unitriangular=True)
        ones = tlo.DiagLinearOperator(torch.ones(5, dtype=torch.float64, device=self.device))
        self.assertAllClose(ones.solve_triangular(rhs, upper=False, unitriangular=True), rhs, rtol=0, atol=0)
        eye = tlo.IdentityLinearOperator(5, dtype=torch.float64, device=self.device)
        self.assertAllClose(eye.solve_triangular(rhs, upper=True), rhs, rtol=0, atol=0)


class TestConstantDiagLinearOperator(JaxParity, LinearOperatorTestCase):
    seed = 2
    should_call_cg = False
    should_call_lanczos = False
    c = positive(22, 3, 1)

    def create_linear_op(self):
        return tlo.ConstantDiagLinearOperator(self.tensor(self.c), diag_shape=6)

    def create_jax_op(self):
        return jlo.ConstantDiagLinearOperator(jx(self.c), diag_shape=6)

    def evaluate_linear_op(self, op):
        return op.diag[..., :, None] * torch.eye(op.diag_shape, dtype=op.diag.dtype, device=self.device)


def _tril(seed, *batch, n=6):
    return np.tril(normal(seed, *batch, n, n)) + 2 * np.eye(n)


class TestTriangularLinearOperator(JaxParity, RectangularLinearOperatorTestCase):
    seed = 0
    t = _tril(30)
    upper = False

    def create_linear_op(self):
        return tlo.TriangularLinearOperator(tlo.DenseLinearOperator(self.tensor(self.t)), upper=self.upper)

    def create_jax_op(self):
        return jlo.TriangularLinearOperator(jlo.DenseLinearOperator(jx(self.t)), upper=self.upper)

    def evaluate_linear_op(self, op):
        t = op.tensor.tensor
        return torch.triu(t) if op.upper else torch.tril(t)

    def test_solve(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self.randn(*op.batch_shape, op.shape[-1], 3)
        self.assertAllClose(op.solve(b), torch.linalg.solve(dense, b), rtol=1e-8, atol=1e-8)

    def test_solve_grad(self):
        op = self.create_linear_op()
        b = self.randn(*op.batch_shape, op.shape[-1], 3)
        self._grad_check(
            op,
            lambda o: torch.sum(torch.sin(o.solve(b))),
            lambda d: torch.sum(torch.sin(torch.linalg.solve(d, b))),
            name="tri_solve",
        )

    def test_inverse(self):
        op = self.create_linear_op()
        self.assertAllClose(
            op.inverse().to_dense(), torch.linalg.inv(self.evaluate_linear_op(op)), rtol=1e-8, atol=1e-8
        )

    def test_logdet_structure(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(op._logdet_structure(), torch.linalg.slogdet(dense)[1], rtol=1e-8, atol=1e-8)

    def test_cholesky_raises(self):
        with self.assertRaises(NotPSDError):
            self.create_linear_op().cholesky()


class TestTriangularLinearOperatorUpperBatch(TestTriangularLinearOperator):
    seed = 1
    t = np.triu(normal(31, 3, 6, 6)) + 2 * np.eye(6)
    upper = True
