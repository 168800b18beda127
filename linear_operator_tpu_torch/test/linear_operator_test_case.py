"""Property-test harness for operators (counterpart of
linear_operator_tpu/test/linear_operator_test_case.py).

A subclass defines ``create_linear_op()`` (a structured operator on the
case's ``device``) and ``evaluate_linear_op(op)`` (the dense matrix computed
from the operator's tensors in plain torch) and inherits every test below:
each public operation is held against the dense computation, its values and
the gradients of every floating tensor of the operator, within a
per-operation tolerance (``tolerances``).

Which algorithm a call dispatched to is checked by ``unittest.mock.patch``
around the solvers (``solvers.linear_cg.linear_cg``, the Lanczos of
``functions._root_decomposition``) under the settings that force each path.
"""

from __future__ import annotations

import importlib
import pickle
import warnings
from unittest import mock

import torch

from .. import settings
from ..operators import LinearOperator
from .base_test_case import BaseTestCase


def _patch_solver(module: str, name: str):
    """``module.name`` wrapped in a mock that records its calls (the
    package's ``solvers`` exports functions under its modules' names, so the
    module is looked up, not reached by attribute)."""
    mod = importlib.import_module(f"linear_operator_tpu_torch.{module}")
    return mock.patch.object(mod, name, wraps=getattr(mod, name))


def _floating(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class RectangularLinearOperatorTestCase(BaseTestCase):
    should_test_getitem_tensor_index = True

    # abstract: pytest collects only the subclasses that define
    # create_linear_op
    __test__ = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.__test__ = cls.create_linear_op is not RectangularLinearOperatorTestCase.create_linear_op

    tolerances = {
        "matmul": {"rtol": 1e-5, "atol": 1e-6},
        "grad": {"rtol": 1e-4, "atol": 1e-6},
        "solve": {"rtol": 1e-4, "atol": 1e-5},
        "solve_grad": {"rtol": 5e-3, "atol": 1e-4},
        "inv_quad": {"rtol": 1e-3, "atol": 1e-4},
        "logdet": {"rtol": 2e-1, "atol": 1e-1},
        "logdet_grad": {"rtol": 1e-1, "atol": 2.5e-1},
        "root_decomposition": {"rtol": 5e-2, "atol": 1e-3},
        "root_inv_decomposition": {"rtol": 2e-2, "atol": 1e-2},
        "sqrt_inv_matmul": {"rtol": 1e-2, "atol": 1e-2},
        "sqrt_inv_matmul_grad": {"rtol": 1e-2, "atol": 1e-2},  # its finite-difference check
        "diagonalization": {"rtol": 5e-2, "atol": 1e-3},
        "sample": {"rtol": 3e-1, "atol": 3e-1},
        "cholesky": {"rtol": 1e-4, "atol": 1e-5},
        "getitem": {"rtol": 1e-5, "atol": 1e-6},
    }

    def create_linear_op(self) -> LinearOperator:
        raise NotImplementedError

    def evaluate_linear_op(self, op: LinearOperator) -> torch.Tensor:
        raise NotImplementedError

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _fresh(leaves, make):
        """``make`` applied to each distinct tensor of ``leaves``: a tensor
        that fills two places (x1 is x2 in a symmetric kernel operator) stays
        one tensor, as the operator's own code may assume."""
        made = {}
        for t in leaves:
            if id(t) not in made:
                made[id(t)] = make(t)
        return [made[id(t)] for t in leaves]

    def _leaf_grads(self, op, fn):
        """d fn(op) / d (each floating tensor of op), through a copy of op
        on fresh leaves; None for the others."""
        leaves = list(op._leaves())
        fresh = self._fresh(leaves, lambda t: t.detach().clone().requires_grad_(True) if _floating(t) else t)
        wanted = list({id(t): t for t in fresh if _floating(t)}.values())
        with torch.enable_grad():
            out = fn(op._with_leaves(fresh))
            grads = torch.autograd.grad(out, wanted, allow_unused=True) if wanted else ()
        by_id = {id(t): (torch.zeros_like(t) if g is None else g) for t, g in zip(wanted, grads)}
        return [by_id[id(t)] if _floating(t) else None for t in fresh]

    def _grad_check(self, op, fn_lazy, fn_dense, name="grad", tol_key="grad", scale_invariant=False):
        """d fn_lazy(op) / d leaves against d fn_dense(dense(op)) / d leaves.

        ``scale_invariant`` divides each leaf's gradients by the largest
        magnitude of the expected one: stochastic (SLQ) gradients carry a
        Monte Carlo error that scales with the gradient."""
        actual = self._leaf_grads(op, fn_lazy)
        expected = self._leaf_grads(op, lambda o: fn_dense(self.evaluate_linear_op(o)))
        tol = self.tolerances[tol_key]
        for i, (ga, ge) in enumerate(zip(actual, expected)):
            if ga is None:
                continue  # index tensors have no gradient
            if scale_invariant:
                scale = torch.clamp(torch.max(torch.abs(ge)), min=1e-12)
                ga, ge = ga / scale, ge / scale
            self.assertAllClose(ga, ge, msg=f"{name}: leaf {i}", **tol)

    def _rand_rhs(self, op, ncols=None, batch=()):
        shape = (*batch, op.shape[-1]) if ncols is None else (*batch, op.shape[-1], ncols)
        return self.randn(*shape, dtype=op.dtype)

    @staticmethod
    def _densify(res):
        return res.to_dense() if isinstance(res, LinearOperator) else res

    # -- shape / dtype / dense -------------------------------------------

    def test_to_dense(self):
        op = self.create_linear_op()
        self.assertAllClose(op.to_dense(), self.evaluate_linear_op(op), **self.tolerances["matmul"])

    def test_shape(self):
        op = self.create_linear_op()
        self.assertEqual(tuple(op.shape), tuple(self.evaluate_linear_op(op).shape))
        self.assertEqual(op.ndim, len(op.shape))
        self.assertEqual(tuple(op.matrix_shape), tuple(op.shape[-2:]))
        self.assertEqual(tuple(op.batch_shape), tuple(op.shape[:-2]))

    def test_representation_roundtrip(self):
        op = self.create_linear_op()
        op2 = op._with_leaves(list(op._leaves()))
        self.assertAllClose(op2.to_dense(), op.to_dense(), rtol=0, atol=0)

    # -- matmul -----------------------------------------------------------

    def test_matmul_vec(self):
        op = self.create_linear_op()
        if op.batch_shape:
            return  # the matrix case covers vector products of batched operators
        dense = self.evaluate_linear_op(op)
        v = self.randn(op.shape[-1], dtype=op.dtype)
        self.assertAllClose(op @ v, dense @ v, **self.tolerances["matmul"])

    def test_matmul_mat(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        rhs = self._rand_rhs(op, ncols=4)
        self.assertAllClose(op @ rhs, dense @ rhs, **self.tolerances["matmul"])
        self._grad_check(
            op,
            lambda o: torch.sum(torch.sin(o @ rhs)),
            lambda d: torch.sum(torch.sin(d @ rhs)),
            name="matmul",
        )

    def test_matmul_mat_broadcast(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        rhs = self.randn(3, *op.batch_shape, op.shape[-1], 2, dtype=op.dtype)
        self.assertAllClose(op @ rhs, dense @ rhs, **self.tolerances["matmul"])

    def test_rmatmul(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        lhs = self.randn(*op.batch_shape, 4, op.shape[-2], dtype=op.dtype)
        self.assertAllClose(op.rmatmul(lhs), lhs @ dense, **self.tolerances["matmul"])

    def test_t_matmul(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        rhs = self.randn(*op.batch_shape, op.shape[-2], 3, dtype=op.dtype)
        self.assertAllClose(op._t_matmul(rhs), dense.mT @ rhs, **self.tolerances["matmul"])

    def test_transpose(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(op.mT.to_dense(), dense.mT, **self.tolerances["matmul"])

    # -- arithmetic -------------------------------------------------------

    def test_add_dense(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        other = self.randn(*op.shape, dtype=op.dtype)
        self.assertAllClose((op + other).to_dense(), dense + other, **self.tolerances["matmul"])

    def test_add_self(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose((op + op).to_dense(), dense * 2, **self.tolerances["matmul"])

    def test_scalar_mul_div(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose((op * 3.0).to_dense(), dense * 3.0, **self.tolerances["matmul"])
        self.assertAllClose((op / 2.0).to_dense(), dense / 2.0, **self.tolerances["matmul"])
        self.assertAllClose((-op).to_dense(), -dense, **self.tolerances["matmul"])
        self.assertAllClose((op * -1.7).to_dense(), dense * -1.7, **self.tolerances["matmul"])

    def test_sub(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        other = self.randn(*op.shape, dtype=op.dtype)
        self.assertAllClose((op - other).to_dense(), dense - other, **self.tolerances["matmul"])

    # -- indexing ---------------------------------------------------------

    def test_getitem_slices(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        n_rows, n_cols = op.matrix_shape
        sl = (Ellipsis, slice(0, max(n_rows // 2, 1)), slice(None))
        self.assertAllClose(self._densify(op[sl]), dense[sl], **self.tolerances["getitem"])
        sl2 = (Ellipsis, slice(None), slice(1, n_cols))
        self.assertAllClose(self._densify(op[sl2]), dense[sl2], **self.tolerances["getitem"])

    def test_getitem_int_row(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(self._densify(op[..., 1, :]), dense[..., 1, :], **self.tolerances["getitem"])

    def test_getitem_int_both(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(self._densify(op[..., 1, 2]), dense[..., 1, 2], **self.tolerances["getitem"])

    def test_getitem_tensor_index(self):
        if not self.should_test_getitem_tensor_index:
            return
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        i = torch.tensor([0, 1, 1], device=self.device)
        j = torch.tensor([1, 0, 2], device=self.device)
        self.assertAllClose(self._densify(op[..., i, j]), dense[..., i, j], **self.tolerances["getitem"])

    def test_getitem_batch(self):
        op = self.create_linear_op()
        if not op.batch_shape:
            return
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(self._densify(op[0]), dense[0], **self.tolerances["getitem"])

    # -- batch-dim manipulation ------------------------------------------

    def test_unsqueeze(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(op.unsqueeze(0).to_dense(), dense[None], **self.tolerances["matmul"])

    def test_expand(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            expanded = op.expand(3, *op.shape)
        self.assertAllClose(expanded.to_dense(), dense.expand(3, *dense.shape), **self.tolerances["matmul"])

    def test_repeat(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        repeated = op.repeat(2, *([1] * op.ndim))
        self.assertAllClose(repeated.to_dense(), dense.repeat(2, *([1] * op.ndim)), **self.tolerances["matmul"])

    def test_sum_batch_dim(self):
        op = self.create_linear_op()
        if not op.batch_shape:
            return
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(self._densify(op.sum(0)), torch.sum(dense, dim=0), **self.tolerances["matmul"])

    def test_prod_batch_dim(self):
        op = self.create_linear_op()
        if not op.batch_shape:
            return
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(self._densify(op.prod(0)), torch.prod(dense, dim=0), **self.tolerances["matmul"])

    def test_permute_batch(self):
        op = self.create_linear_op()
        if len(op.batch_shape) < 2:
            return
        dense = self.evaluate_linear_op(op)
        nb = len(op.batch_shape)
        perm = tuple(reversed(range(nb)))
        res = op.permute(*perm, nb, nb + 1)
        self.assertAllClose(self._densify(res), dense.permute(*perm, nb, nb + 1), **self.tolerances["matmul"])

    def test_getitem_batch_tensor_index(self):
        op = self.create_linear_op()
        if not op.batch_shape:
            return
        dense = self.evaluate_linear_op(op)
        idx = torch.tensor([0, op.batch_shape[0] - 1], device=self.device)
        self.assertAllClose(self._densify(op[idx]), dense[idx], **self.tolerances["getitem"])

    def test_getitem_matrix_tensor_row_lazy(self):
        """A 1-D index tensor on the row dim stays lazy."""
        if not self.should_test_getitem_tensor_index:
            return
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        idx = torch.tensor([0, min(2, op.shape[-2] - 1), 1], device=self.device)
        res = op[..., idx, :]
        self.assertIsInstance(res, LinearOperator)
        self.assertAllClose(res.to_dense(), dense[..., idx, :], **self.tolerances["getitem"])
        v = self.randn(*op.batch_shape, op.shape[-1], 2, dtype=op.dtype)
        self.assertAllClose(res @ v, dense[..., idx, :] @ v, **self.tolerances["matmul"])

    def test_pickle(self):
        op = self.create_linear_op()
        unpickled = pickle.loads(pickle.dumps(op))
        self.assertIsInstance(unpickled, type(op))
        self.assertAllClose(unpickled.to_dense(), op.to_dense(), rtol=1e-14, atol=1e-14)
        self.assertEqual(
            [(tuple(t.shape), t.dtype) for t in op._leaves()],
            [(tuple(t.shape), t.dtype) for t in unpickled._leaves()],
        )

    def test_detach_astype(self):
        op = self.create_linear_op()
        self.assertAllClose(op.detach().to_dense(), op.to_dense(), rtol=0, atol=0)
        self.assertEqual(op.astype(torch.float32).dtype, torch.float32)

    def test_dtype_roundtrip(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        f32 = op.float()
        self.assertEqual(f32.dtype, torch.float32)
        back = f32.double() if op.dtype == torch.float64 else f32.astype(op.dtype)
        self.assertEqual(back.dtype, op.dtype)
        self.assertAllClose(
            back.to_dense().to(op.dtype), dense.to(torch.float32).to(op.dtype), rtol=1e-6, atol=1e-6
        )

    def test_isclose(self):
        op = self.create_linear_op()
        self.assertTrue(bool(torch.all(op.isclose(self.evaluate_linear_op(op)))))


class LinearOperatorTestCase(RectangularLinearOperatorTestCase):
    """The tests of square PSD operators."""

    should_test_sample = True
    should_call_cg = True
    should_call_lanczos = True
    skip_slq_tests = False
    # the probes of test_inv_quad_logdet_stochastic_grad: its error is Monte
    # Carlo, ~|grad| / sqrt(probes)
    slq_grad_trace_samples = 4096

    # -- structure --------------------------------------------------------

    def _eye(self, op):
        return torch.eye(op.shape[-1], dtype=op.dtype, device=self.device)

    def test_diagonal(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(op.diagonal(), torch.diagonal(dense, dim1=-2, dim2=-1), **self.tolerances["matmul"])

    def test_add_jitter(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(op.add_jitter(0.4).to_dense(), dense + 0.4 * self._eye(op), **self.tolerances["matmul"])

    def test_add_diagonal(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        d = torch.abs(self.randn(op.shape[-1], dtype=op.dtype)) + 1.0
        self.assertAllClose(op.add_diagonal(d).to_dense(), dense + torch.diag(d), **self.tolerances["matmul"])
        self.assertAllClose(op.add_jitter(0.5).to_dense(), dense + 0.5 * self._eye(op), **self.tolerances["matmul"])

    def test_add_low_rank(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        v = self.randn(*op.batch_shape, op.shape[-1], 2, dtype=op.dtype)
        self.assertAllClose(op.add_low_rank(v).to_dense(), dense + v @ v.mT, **self.tolerances["matmul"])

    # -- factorization ----------------------------------------------------

    def test_cholesky(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        L = op.cholesky().to_dense()
        self.assertAllClose(L @ L.mT, dense, **self.tolerances["cholesky"])

    def test_root_decomposition_exact(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        with settings.fast_computations(covar_root_decomposition=False):
            root = op.root_decomposition().root.to_dense()
        self.assertAllClose(root @ root.mT, dense, **self.tolerances["cholesky"])

    def test_root_decomposition_lanczos(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        with settings.max_cholesky_size(0):
            with _patch_solver("functions._root_decomposition", "lanczos_tridiag") as lanczos_mock:
                root_op = op.root_decomposition(generator=self.generator)
                if self.should_call_lanczos and op._root_structure() is None:
                    self.assertTrue(lanczos_mock.called, "expected Lanczos to be invoked")
        root = root_op.root.to_dense()
        self.assertAllClose(root @ root.mT, dense, **self.tolerances["root_decomposition"])

    def test_root_inv_decomposition(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        # several Lanczos probes, the best kept by its residual
        probes = self.randn(*op.batch_shape, op.shape[-1], 3, dtype=op.dtype)
        inv_root = op.root_inv_decomposition(initial_vectors=probes, generator=self.generator).root.to_dense()
        self.assertAllClose(inv_root @ inv_root.mT, torch.linalg.inv(dense), **self.tolerances["root_inv_decomposition"])

    def test_diagonalization(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        evals, evecs = op.diagonalization()
        evecs = self._densify(evecs)
        recon = torch.einsum("...ij,...j,...kj->...ik", evecs, evals, evecs)
        self.assertAllClose(recon, dense, **self.tolerances["diagonalization"])

    def test_eigvalsh(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        self.assertAllClose(op.eigvalsh(), torch.linalg.eigvalsh(dense), **self.tolerances["matmul"])

    def test_svd(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        U, S, V = op.svd()
        recon = U.to_dense() * S[..., None, :] @ V.to_dense().mT
        self.assertAllClose(recon, dense, **self.tolerances["cholesky"])

    def test_pivoted_cholesky(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        L = op.pivoted_cholesky(rank=op.shape[-1], error_tol=0.0)
        self.assertAllClose(L @ L.mT, dense, rtol=1e-3, atol=1e-3)

    # -- solves -----------------------------------------------------------

    def test_solve_vec_cholesky(self):
        op = self.create_linear_op()
        if op.batch_shape:
            return
        dense = self.evaluate_linear_op(op)
        b = self.randn(op.shape[-1], dtype=op.dtype)
        with settings.fast_computations(solves=False):
            x = op.solve(b)
        self.assertAllClose(x, torch.linalg.solve(dense, b), **self.tolerances["solve"])

    def test_solve_mat_cholesky(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self._rand_rhs(op, ncols=3, batch=op.batch_shape)
        with settings.fast_computations(solves=False):
            x = op.solve(b)
            self.assertAllClose(x, torch.linalg.solve(dense, b), **self.tolerances["solve"])
            self._grad_check(
                op,
                lambda o: torch.sum(torch.sin(o.solve(b))),
                lambda d: torch.sum(torch.sin(torch.linalg.solve(d, b))),
                name="solve_chol",
                tol_key="solve_grad",
            )

    def test_solve_mat_cg(self):
        if not self.should_call_cg:
            return
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self._rand_rhs(op, ncols=3, batch=op.batch_shape)
        with settings.max_cholesky_size(0), settings.cg_tolerance(1e-8), settings.max_cg_iterations(2000):
            with _patch_solver("solvers.linear_cg", "linear_cg") as cg_mock:
                x = op.solve(b)
                if op._solve_structure(b) is None:
                    self.assertTrue(cg_mock.called, "expected CG to be invoked")
        self.assertAllClose(x, torch.linalg.solve(dense, b), **self.tolerances["solve"])
        with settings.max_cholesky_size(0), settings.cg_tolerance(1e-10), settings.max_cg_iterations(2000):
            self._grad_check(
                op,
                lambda o: torch.sum(torch.sin(o.solve(b))),
                lambda d: torch.sum(torch.sin(torch.linalg.solve(d, b))),
                name="solve_cg",
                tol_key="solve_grad",
            )

    def test_solve_mat_broadcast_rhs(self):
        """An rhs with an extra leading batch dim broadcasts against the
        operator's batch, on the Cholesky and the CG path."""
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self.randn(2, *op.batch_shape, op.shape[-1], 3, dtype=op.dtype)
        with settings.fast_computations(solves=False):
            x = op.solve(b)
        self.assertAllClose(x, torch.linalg.solve(dense, b), **self.tolerances["solve"])
        if self.should_call_cg:
            with settings.max_cholesky_size(0), settings.cg_tolerance(1e-8), settings.max_cg_iterations(2000):
                x = op.solve(b)
            self.assertAllClose(x, torch.linalg.solve(dense, b), **self.tolerances["solve"])

    def test_solve_with_lhs(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self._rand_rhs(op, ncols=3, batch=op.batch_shape)
        lhs = self.randn(*op.batch_shape, 2, op.shape[-1], dtype=op.dtype)
        with settings.fast_computations(solves=False):
            x = op.solve(b, lhs)
        self.assertAllClose(x, lhs @ torch.linalg.solve(dense, b), **self.tolerances["solve"])

    # -- inv_quad_logdet --------------------------------------------------

    @staticmethod
    def _iq_true(dense, b):
        return torch.sum(torch.linalg.solve(dense, b) * b, dim=(-2, -1))

    def test_inv_quad_logdet_cholesky(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self._rand_rhs(op, ncols=3, batch=op.batch_shape)
        with settings.fast_computations(log_prob=False, solves=False):
            iq, ld = op.inv_quad_logdet(b, logdet=True)
            self.assertAllClose(iq, self._iq_true(dense, b), **self.tolerances["inv_quad"])
            self.assertAllClose(ld, torch.linalg.slogdet(dense)[1], rtol=1e-3, atol=1e-3)
            self._grad_check(
                op,
                lambda o: (lambda r: torch.sum(r[0]) + torch.sum(r[1]))(o.inv_quad_logdet(b, logdet=True)),
                lambda d: torch.sum(self._iq_true(d, b)) + torch.sum(torch.linalg.slogdet(d)[1]),
                name="iqld_chol",
                tol_key="solve_grad",
            )

    def test_inv_quad_logdet_stochastic(self):
        if self.skip_slq_tests:
            return
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self._rand_rhs(op, ncols=3, batch=op.batch_shape)
        with settings.max_cholesky_size(0), settings.cg_tolerance(1e-8), settings.max_cg_iterations(2000), \
                settings.num_trace_samples(128), settings.max_lanczos_quadrature_iterations(64):
            iq, ld = op.inv_quad_logdet(b, logdet=True, generator=self.generator)
        self.assertAllClose(iq, self._iq_true(dense, b), **self.tolerances["inv_quad"])
        self.assertAllClose(ld, torch.linalg.slogdet(dense)[1], **self.tolerances["logdet"])

    def test_inv_quad_logdet_stochastic_grad(self):
        if self.skip_slq_tests:
            return
        op = self.create_linear_op()
        b = self._rand_rhs(op, ncols=3, batch=op.batch_shape)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.generator))
        # SLQ gradients are Hutchinson estimates, |error| ~ |grad| / sqrt(m):
        # the check needs many probes.  The gradient reads the probes' solves;
        # the Lanczos cap sets only the forward's quadrature, which is exact
        # after n steps on an n x n operator
        with settings.max_cholesky_size(0), settings.cg_tolerance(1e-10), settings.max_cg_iterations(2000), \
                settings.num_trace_samples(self.slq_grad_trace_samples), \
                settings.max_lanczos_quadrature_iterations(min(64, op.shape[-1])):
            self._grad_check(
                op,
                lambda o: (lambda r: torch.sum(r[0] + r[1]))(
                    o.inv_quad_logdet(b, logdet=True, generator=torch.Generator().manual_seed(seed))
                ),
                lambda d: torch.sum(self._iq_true(d, b) + torch.linalg.slogdet(d)[1]),
                name="iqld_slq",
                tol_key="logdet_grad",
                scale_invariant=True,
            )

    def test_logdet(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        with settings.fast_computations(log_prob=False):
            ld = op.logdet()
        self.assertAllClose(ld, torch.linalg.slogdet(dense)[1], rtol=1e-3, atol=1e-3)

    def test_inv_quad_no_reduce(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self._rand_rhs(op, ncols=3, batch=op.batch_shape)
        with settings.fast_computations(log_prob=False, solves=False):
            iq = op.inv_quad(b, reduce_inv_quad=False)
        self.assertAllClose(iq, torch.sum(torch.linalg.solve(dense, b) * b, dim=-2), **self.tolerances["inv_quad"])

    # -- derived operators -------------------------------------------------

    def test_mul_with_operator(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        with settings.fast_computations(covar_root_decomposition=False):
            res = self._densify(op.mul(op))
        self.assertAllClose(res, dense * dense, rtol=1e-3, atol=1e-3)

    def test_add_low_rank_with_roots(self):
        """A root the operator carries is updated (the result is a root
        operator whose root reconstructs K + V V^T); none is computed."""
        from ..operators.root import RootLinearOperator

        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        v = self.randn(*op.batch_shape, op.shape[-1], 2, dtype=op.dtype)
        with settings.fast_computations(covar_root_decomposition=False):
            updated = op.with_factorization(op.root_decomposition()).add_low_rank(v)
        self.assertIsInstance(updated, RootLinearOperator)
        root = updated.root.to_dense()
        self.assertAllClose(root @ root.mT, dense + v @ v.mT, **self.tolerances["root_decomposition"])

    def test_cat_rows(self):
        """Appended rows and columns: the result is the dense block matrix,
        and with a carried root its root reconstructs it."""
        from ..operators.root import RootLinearOperator

        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        m = 2
        B = self.randn(*op.batch_shape, op.shape[-1], m, dtype=op.dtype) * 0.1
        with settings.fast_computations(solves=False):
            KinvB = op.solve(B)
        C = B.mT @ KinvB + torch.eye(m, dtype=op.dtype, device=self.device)
        block = torch.cat([torch.cat([dense, B], dim=-1), torch.cat([B.mT, C], dim=-1)], dim=-2)
        Bt = B.mT  # cross_mat holds the new rows (m, n)
        with settings.fast_computations(covar_root_decomposition=False, solves=False):
            lazy = op.cat_rows(Bt, C, generate_roots=False)
            self.assertAllClose(lazy.to_dense(), block, **self.tolerances["matmul"])
            # roots are updated, never created: seed one, then append
            rooted = op.with_factorization(op.root_decomposition()).cat_rows(Bt, C)
        self.assertIsInstance(rooted, RootLinearOperator)
        root = rooted.root.to_dense()
        self.assertAllClose(root @ root.mT, block, **self.tolerances["root_decomposition"])

    def test_sqrt_inv_matmul_grad(self):
        """The gradient of K^{-1/2} rhs, held against a central finite
        difference along a random direction of the operator's tensors."""
        op = self.create_linear_op()
        if op.batch_shape:
            return
        rhs = self._rand_rhs(op, ncols=2)
        leaves = list(op._leaves())

        def f(ls):
            return torch.sum(op._with_leaves(ls).sqrt_inv_matmul(rhs))

        with settings.minres_tolerance(1e-13), settings.num_contour_quadrature(31):
            grads = self._leaf_grads(op, lambda o: torch.sum(o.sqrt_inv_matmul(rhs)))
        tangent = self._fresh(leaves, lambda t: self.randn(*t.shape, dtype=t.dtype) if _floating(t) else None)
        eps = 1e-5

        direction = {id(t): d for t, d in zip(leaves, tangent)}

        def shift(sign):
            return self._fresh(leaves, lambda t: t.detach() + sign * eps * direction[id(t)] if _floating(t) else t)

        with settings.minres_tolerance(1e-13), settings.num_contour_quadrature(31), torch.no_grad():
            fd = (f(shift(+1)) - f(shift(-1))) / (2 * eps)
        # a tensor that fills two places counts once
        pairs = {id(t): (g, d) for t, g, d in zip(leaves, grads, tangent) if d is not None}
        dot = sum(torch.sum(g * d) for g, d in pairs.values())
        self.assertAllClose(dot, fd, **self.tolerances["sqrt_inv_matmul_grad"])

    def test_sqrt_inv_matmul(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        rhs = self._rand_rhs(op, ncols=2, batch=op.batch_shape)
        evals, evecs = torch.linalg.eigh(dense)
        inv_sqrt_dense = (evecs / torch.sqrt(evals)[..., None, :]) @ evecs.mT
        with settings.minres_tolerance(1e-10), settings.num_contour_quadrature(31):
            res = op.sqrt_inv_matmul(rhs)
        self.assertAllClose(res, inv_sqrt_dense @ rhs, **self.tolerances["sqrt_inv_matmul"])
        lhs = self.randn(*op.batch_shape, 2, op.shape[-1], dtype=op.dtype)
        with settings.minres_tolerance(1e-10), settings.num_contour_quadrature(31):
            sqrt_inv, inv_quad = op.sqrt_inv_matmul(rhs, lhs)
        self.assertAllClose(sqrt_inv, lhs @ inv_sqrt_dense @ rhs, **self.tolerances["sqrt_inv_matmul"])
        # the second output is the row-wise lhs K^{-1} lhs^T
        inv_dense = torch.linalg.inv(dense)
        self.assertAllClose(
            inv_quad, torch.einsum("...ij,...jk,...ik->...i", lhs, inv_dense, lhs), **self.tolerances["sqrt_inv_matmul"]
        )

    def test_prod_lazy(self):
        op = self.create_linear_op()
        if not op.batch_shape:
            return
        dense = self.evaluate_linear_op(op)
        res = op.prod(0, lazy=True)
        self.assertIsInstance(res, LinearOperator)
        self.assertAllClose(res.to_dense(), torch.prod(dense, dim=0), **self.tolerances["root_decomposition"])

    def test_factored_reuse(self):
        op = self.create_linear_op()
        dense = self.evaluate_linear_op(op)
        b = self._rand_rhs(op, ncols=2, batch=op.batch_shape)
        with settings.fast_computations(solves=False, log_prob=False):
            f = op.cholesky()
            x = op.solve(b, factored=f)
            iq, ld = op.inv_quad_logdet(b, logdet=True, factored=f)
        self.assertAllClose(x, torch.linalg.solve(dense, b), **self.tolerances["solve"])
        self.assertAllClose(iq, self._iq_true(dense, b), **self.tolerances["inv_quad"])
        self.assertAllClose(ld, torch.linalg.slogdet(dense)[1], rtol=1e-3, atol=1e-3)

    # -- algorithm routing ------------------------------------------------

    def test_no_cg_below_cutoff(self):
        """With fast solves off, CG does not run."""
        op = self.create_linear_op()
        b = self._rand_rhs(op, ncols=2, batch=op.batch_shape)
        with settings.fast_computations(solves=False, log_prob=False):
            with _patch_solver("solvers.linear_cg", "linear_cg") as cg_mock:
                op.solve(b)
                op.inv_quad_logdet(b, logdet=True)
        self.assertFalse(cg_mock.called, "CG must not run on the Cholesky path")

    # -- sampling ---------------------------------------------------------

    def test_zero_mean_mvn_samples(self):
        if not self.should_test_sample:
            return
        op = self.create_linear_op()
        if op.batch_shape:
            return
        dense = self.evaluate_linear_op(op)
        samples = op.zero_mean_mvn_samples(20000, generator=self.generator)
        emp_cov = torch.einsum("si,sj->ij", samples, samples) / samples.shape[0]
        # Monte Carlo error scales with the covariance: compare normalized
        scale = torch.clamp(torch.max(torch.abs(dense)), min=1e-12)
        self.assertAllClose(emp_cov / scale, dense / scale, **self.tolerances["sample"])
