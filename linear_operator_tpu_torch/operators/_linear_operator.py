"""Abstract base class for lazy (batched) linear operators.

PyTorch counterpart of ``linear_operator_tpu/operators/_linear_operator.py``,
ported as far as the exact-GP, Woodbury, sampling and structured slices need
it.  An operator represents a (batch of) M x N matrix implicitly through
``_matmul``, ``_shape`` and ``_transpose``; everything else is built on them.

Operators are plain classes whose fields are tensors, nested operators or
static values.  ``_leaves`` walks the tensors and ``_map_tensors`` rebuilds a
copy with every tensor mapped (``detach`` is one such map; ``_with_leaves``,
the inverse of ``_leaves``, is another), which replaces the JAX package's
pytree flattening.
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Iterator

import torch

from .. import settings
from ..utils.broadcasting import broadcast_shapes, matmul_broadcast_shape


def _map_value(value, fn):
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, LinearOperator):
        return value._map_tensors(fn)
    if isinstance(value, tuple):
        return tuple(_map_value(v, fn) for v in value)
    if isinstance(value, dict):
        return {k: _map_value(v, fn) for k, v in value.items()}
    return value


def _iter_tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, LinearOperator):
        yield from value._leaves()
    elif isinstance(value, tuple):
        for v in value:
            yield from _iter_tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _iter_tensors(v)


class LinearOperator:
    """A (batch of) M x N linear operator(s), defined implicitly."""

    # ------------------------------------------------------------------
    # Required primitives
    # ------------------------------------------------------------------

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        """(*b, M, N) @ (*b2, N, T) -> (broadcast(b, b2), M, T)."""
        raise NotImplementedError

    def _shape(self) -> tuple[int, ...]:
        raise NotImplementedError

    def _transpose(self) -> "LinearOperator":
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Fields
    # ------------------------------------------------------------------

    def _leaves(self) -> Iterator[torch.Tensor]:
        """Every tensor field, nested operators included."""
        for value in vars(self).values():
            yield from _iter_tensors(value)

    def _map_tensors(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """A shallow copy with ``fn`` applied to every tensor field."""
        out = copy.copy(self)
        for name, value in vars(self).items():
            setattr(out, name, _map_value(value, fn))
        return out

    def _with_leaves(self, leaves) -> "LinearOperator":
        """A copy whose tensor fields are ``leaves``, in ``_leaves`` order."""
        it = iter(leaves)
        out = self._map_tensors(lambda _: next(it))
        if next(it, None) is not None:
            raise ValueError("more leaves than the operator has tensors")
        return out

    def _replace(self, **fields):
        out = copy.copy(self)
        for name, value in fields.items():
            setattr(out, name, value)
        return out

    # ------------------------------------------------------------------
    # Shape, dtype, device
    # ------------------------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._shape())

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.shape[:-2]

    @property
    def matrix_shape(self) -> tuple[int, int]:
        return self.shape[-2:]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_square(self) -> bool:
        return self.shape[-1] == self.shape[-2]

    @property
    def _inherently_triangular(self) -> bool:
        """True when the operator is triangular by construction (a Kronecker
        product of triangular or diagonal factors), so that a
        TriangularLinearOperator around it keeps its structured paths."""
        return False

    @property
    def dtype(self) -> torch.dtype:
        dtypes = [t.dtype for t in self._leaves() if t.is_floating_point()]
        if not dtypes:
            return torch.get_default_dtype()
        out = dtypes[0]
        for dt in dtypes[1:]:
            out = torch.promote_types(out, dt)
        return out

    @property
    def device(self) -> torch.device | None:
        for t in self._leaves():
            return t.device
        return None

    @property
    def mT(self) -> "LinearOperator":
        return self._transpose()

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape}, dtype={self.dtype})"

    def detach(self) -> "LinearOperator":
        """Copy with every tensor detached from autograd."""
        return self._map_tensors(torch.Tensor.detach)

    # ------------------------------------------------------------------
    # Derived primitives
    # ------------------------------------------------------------------

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._transpose()._matmul(rhs)

    def _bilinear_derivative(self, left_vecs: torch.Tensor, right_vecs: torch.Tensor) -> tuple:
        """Gradients of ``sum(left * (K @ right))`` with respect to the
        operator's tensors, as a tuple aligned with ``_leaves()``; None for a
        leaf that does not require grad.

        The JAX package's default backward (one ``jax.grad`` of the mat-mul):
        the operator is rebuilt from detached leaves and ``_matmul`` is
        differentiated by autograd.  A tensor that appears twice among the
        leaves (x1 is x2 in a symmetric kernel) gets one partial for each
        place.  Subclasses with a cheaper form override it."""
        leaves = list(self._leaves())
        needs = [t.requires_grad for t in leaves]
        if not any(needs):
            return (None,) * len(leaves)
        with torch.enable_grad():
            fresh = [t.detach().requires_grad_(r) for t, r in zip(leaves, needs)]
            out = self._with_leaves(fresh)._matmul(right_vecs)
            grads = torch.autograd.grad(
                torch.sum(left_vecs * out), [t for t in fresh if t.requires_grad], allow_unused=True
            )
        it = iter(grads)
        return tuple(next(it) if r else None for r in needs)

    def _diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.to_dense(), dim1=-2, dim2=-1)

    def diagonal(self) -> torch.Tensor:
        return self._diagonal()

    def to_dense(self) -> torch.Tensor:
        n = self.shape[-1]
        eye = torch.eye(n, dtype=self.dtype, device=self.device)
        return self._matmul(eye.expand(*self.batch_shape, n, n))

    # ------------------------------------------------------------------
    # Structure hooks (``None`` = no fast path)
    # ------------------------------------------------------------------

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor | None:
        return None

    def _logdet_structure(self) -> torch.Tensor | None:
        return None

    def _inv_quad_logdet_structure(self, rhs, logdet: bool):
        return None

    def _cholesky_impl(self, upper: bool = False) -> "LinearOperator":
        """Cholesky factor as a TriangularLinearOperator (dense
        ``psd_safe_cholesky``)."""
        from ..utils.cholesky import psd_safe_cholesky
        from .triangular import TriangularLinearOperator

        L = psd_safe_cholesky(self.to_dense())
        if upper:
            return TriangularLinearOperator(L.mT, upper=True)
        return TriangularLinearOperator(L, upper=False)

    def _root_structure(self) -> "LinearOperator | None":
        """A closed-form root R with K = R R^T (Diag: its square root), or
        None."""
        return None

    def _root_inv_structure(self) -> "LinearOperator | None":
        """A closed-form root of K^{-1}, or None."""
        return None

    def _preconditioner(self):
        """(closure, preconditioner_operator, logdet_of_preconditioner) or
        (None, None, None)."""
        return None, None, None

    def _matmul_closure(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Mat-vec closure for iterative solvers, built once per solve;
        operators with per-solve setup override it."""
        return self._matmul

    def _solve_via_cg(self, rhs, preconditioner=None, n_tridiag: int = 0):
        from ..solvers.linear_cg import linear_cg

        return linear_cg(
            self._matmul_closure(),
            rhs,
            preconditioner=preconditioner,
            n_tridiag=n_tridiag,
        )

    # ------------------------------------------------------------------
    # Matmul and arithmetic
    # ------------------------------------------------------------------

    def matmul(self, other: torch.Tensor) -> torch.Tensor:
        if isinstance(other, LinearOperator):
            raise NotImplementedError(
                "lazy operator @ operator products are not ported yet"
            )
        if other.ndim == 1:
            return self._matmul(other[..., None])[..., 0]
        if settings.debug.on():
            matmul_broadcast_shape(self.shape, tuple(other.shape))
        return self._matmul(other)

    def __matmul__(self, other):
        return self.matmul(other)

    def __add__(self, other):
        """Structure-dispatching sum: a diagonal gives an AddedDiag (or the
        subclass's own structure), an operator a lazy sum, a scalar a dense
        operator, a tensor a lazy sum with it."""
        from .added_diag import AddedDiagLinearOperator
        from .dense import DenseLinearOperator
        from .diag import DiagLinearOperator
        from .sum import SumLinearOperator

        if isinstance(other, DiagLinearOperator):
            return AddedDiagLinearOperator(self, other)
        if isinstance(other, LinearOperator):
            return SumLinearOperator((self, other))
        other = torch.as_tensor(other, dtype=self.dtype, device=self.device)
        if other.ndim == 0:
            return DenseLinearOperator(self.to_dense() + other)
        return SumLinearOperator((self, DenseLinearOperator(other)))

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self.__add__(other * -1)

    def __rsub__(self, other):
        return (self * -1).__add__(other)

    def __neg__(self):
        return self * -1

    def add(self, other, alpha: float | None = None) -> "LinearOperator":
        """``self + alpha * other``."""
        return self + other if alpha is None else self + other * alpha

    def mul(self, other) -> "LinearOperator":
        """Product with a constant: a scalar, a batch-shaped tensor, or one
        whose matrix dims are (1, 1), as a ConstantMulLinearOperator.  The
        elementwise product with an operator or a full-size tensor needs
        MulLinearOperator, which is not ported yet (ROADMAP queue 1 item 5)."""
        from .constant_mul import ConstantMulLinearOperator

        if not isinstance(other, LinearOperator):
            const = torch.as_tensor(other, dtype=self.dtype, device=self.device)
            unit_matrix = const.ndim >= 2 and tuple(const.shape[-2:]) == (1, 1)
            if const.ndim == 0 or unit_matrix or const.ndim <= self.ndim - 2:
                # ConstantMul holds a batch-shaped constant and appends the
                # (1, 1) matrix dims itself
                return ConstantMulLinearOperator(self, const[..., 0, 0] if unit_matrix else const)
        raise NotImplementedError(
            "the elementwise product with an operator or a full-size tensor needs "
            "MulLinearOperator, which is not ported yet (ROADMAP queue 1 item 5)"
        )

    def __mul__(self, other):
        return self.mul(other)

    def __rmul__(self, other):
        return self.mul(other)

    def __truediv__(self, other):
        return self.mul(1.0 / torch.as_tensor(other, dtype=self.dtype, device=self.device))

    def sqrt(self) -> "LinearOperator":
        raise NotImplementedError(f"sqrt({type(self).__name__}) is not implemented.")

    def add_diagonal(self, diag) -> "LinearOperator":
        """K + diag(d); a scalar or trailing-singleton ``diag`` becomes a
        ConstantDiagLinearOperator."""
        from .diag import diag_operator

        if not self.is_square:
            raise RuntimeError("add_diagonal requires a square operator")
        return self + diag_operator(diag, self)

    def add_jitter(self, jitter_val: float = 1e-3) -> "LinearOperator":
        """K + jitter_val I."""
        return self.add_diagonal(jitter_val)

    # ------------------------------------------------------------------
    # Solves, quadratic forms, log-determinants (see ``functions``)
    # ------------------------------------------------------------------

    def solve(self, rhs: torch.Tensor, lhs: torch.Tensor | None = None) -> torch.Tensor:
        """K^{-1} rhs, or lhs @ K^{-1} rhs."""
        from ..functions import solve

        return solve(self, rhs, lhs)

    def inv_quad(self, rhs: torch.Tensor, reduce_inv_quad: bool = True) -> torch.Tensor:
        """rhs^T K^{-1} rhs, summed over the columns with ``reduce_inv_quad``."""
        from ..functions import inv_quad

        return inv_quad(self, rhs, reduce_inv_quad=reduce_inv_quad)

    def inv_quad_logdet(
        self,
        inv_quad_rhs: torch.Tensor | None = None,
        logdet: bool = False,
        reduce_inv_quad: bool = True,
        *,
        generator: torch.Generator | None = None,
    ):
        """(rhs^T K^{-1} rhs, log|K|) from one batched solve."""
        from ..functions import inv_quad_logdet

        return inv_quad_logdet(
            self, inv_quad_rhs, logdet=logdet, reduce_inv_quad=reduce_inv_quad, generator=generator
        )

    def logdet(self, *, generator: torch.Generator | None = None) -> torch.Tensor:
        _, ld = self.inv_quad_logdet(None, logdet=True, generator=generator)
        return ld

    def sqrt_inv_matmul(
        self, rhs: torch.Tensor, lhs: torch.Tensor | None = None, *, generator: torch.Generator | None = None
    ):
        """K^{-1/2} rhs by contour integral quadrature (see
        ``functions.sqrt_inv_matmul``); ``generator`` draws the Lanczos start
        of the eigenvalue-range estimate (a fixed one when None)."""
        from ..functions import sqrt_inv_matmul

        return sqrt_inv_matmul(self, rhs, lhs, generator=generator)

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    def zero_mean_mvn_samples(self, num_samples: int, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """N(0, K) draws of shape (num_samples, *b, N): K^{1/2} z by contour
        integral quadrature under ``settings.ciq_samples``, else R z with R
        the operator's root decomposition.  ``generator`` draws z and the
        decomposition's start vector on its own device (a fixed CPU
        generator when None)."""
        from ..utils.random import randn

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if settings.ciq_samples.on():
            from ..functions import sqrt_matmul_ciq

            base = randn((*self.batch_shape, self.shape[-1], num_samples), self.dtype, self.device, generator)
            return sqrt_matmul_ciq(self, base, generator=generator).movedim(-1, 0)
        root = self.root_decomposition(generator=generator).root
        base = randn((*self.batch_shape, root.shape[-1], num_samples), self.dtype, self.device, generator)
        return root.matmul(base).movedim(-1, 0)

    # ------------------------------------------------------------------
    # Batch dims
    # ------------------------------------------------------------------

    def _expand_batch(self, batch_shape: tuple[int, ...]) -> "LinearOperator":
        """Dense fallback; structured subclasses broadcast their tensors."""
        from ..utils.warnings import PerformanceWarning
        from .dense import DenseLinearOperator

        warnings.warn(
            f"{type(self).__name__} fell back to dense materialization in _expand_batch.",
            PerformanceWarning,
        )
        return DenseLinearOperator(self.to_dense().expand(*batch_shape, *self.matrix_shape))

    def _expanded_to(self, batch_shape: tuple[int, ...]) -> "LinearOperator":
        """Self expanded to ``batch_shape`` when its own batch is narrower
        (itself otherwise); composite operators call it on their children
        before applying batch indices."""
        if tuple(self.batch_shape) == tuple(batch_shape):
            return self
        return self._expand_batch(tuple(batch_shape))

    def expand(self, *sizes) -> "LinearOperator":
        """The operator broadcast to the batch shape ``sizes[:-2]`` (-1 keeps
        a dim); the matrix dims cannot change."""
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list, torch.Size)):
            sizes = tuple(sizes[0])
        if tuple(sizes[-2:]) != tuple(self.matrix_shape):
            raise RuntimeError(f"expand cannot change matrix shape {self.matrix_shape}")
        own = (1,) * (len(sizes) - 2 - len(self.batch_shape)) + tuple(self.batch_shape)
        batch = tuple(s if new == -1 else new for new, s in zip(sizes[:-2], own))
        return self._expand_batch(broadcast_shapes(batch, self.batch_shape))

    # ------------------------------------------------------------------
    # Factorizations
    # ------------------------------------------------------------------

    def cholesky(self, upper: bool = False) -> "LinearOperator":
        """Lower (or upper) Cholesky factor as a TriangularLinearOperator."""
        return self._cholesky_impl(upper=upper)

    def _choose_root_method(self) -> str:
        """Cholesky up to ``max_cholesky_size`` (or with fast root
        decompositions off), Lanczos above it."""
        if (
            settings.fast_computations.covar_root_decomposition.off()
            or self.shape[-1] <= settings.max_cholesky_size.value()
        ):
            return "cholesky"
        return "lanczos"

    def root_decomposition(self, method: str | None = None, *, generator: torch.Generator | None = None):
        """An operator equal to self carrying a root R with K = R R^T (see
        ``functions.root_decomposition``)."""
        from ..functions import root_decomposition

        return root_decomposition(self, method=method, generator=generator)

    def root_inv_decomposition(
        self,
        initial_vectors: torch.Tensor | None = None,
        test_vectors: torch.Tensor | None = None,
        method: str | None = None,
        *,
        generator: torch.Generator | None = None,
    ):
        """An operator equal to self^{-1} carrying a root; with several
        ``initial_vectors`` the best probe is picked by the ``test_vectors``
        residual test (see ``functions.root_inv_decomposition``)."""
        from ..functions import root_inv_decomposition

        return root_inv_decomposition(
            self, method=method, generator=generator, initial_vectors=initial_vectors, test_vectors=test_vectors
        )

    def diagonalization(self, method: str | None = None, *, generator: torch.Generator | None = None):
        """(evals, evecs) with K ~= Q diag(evals) Q^T."""
        from ..functions import diagonalization

        return diagonalization(self, method=method, generator=generator)

    def eigh(self):
        """(evals, evecs as a DenseLinearOperator), with a backward that stays
        finite at repeated eigenvalues (``utils.eigh.eigh_safe``)."""
        from ..utils.eigh import eigh_safe
        from .dense import DenseLinearOperator

        if settings.debug.on() and not self.is_square:
            raise RuntimeError("eigh requires a square (symmetric) operator")
        evals, evecs = eigh_safe(self.to_dense())
        return evals, DenseLinearOperator(evecs)

    def eigvalsh(self) -> torch.Tensor:
        return torch.linalg.eigvalsh(self.to_dense())

    def svd(self):
        """(U, S, V) with U and V DenseLinearOperators."""
        from .dense import DenseLinearOperator

        U, S, Vt = torch.linalg.svd(self.to_dense(), full_matrices=False)
        return DenseLinearOperator(U), S, DenseLinearOperator(Vt.mT)

    # ------------------------------------------------------------------
    # Indexing
    # ------------------------------------------------------------------

    def pivoted_cholesky(self, rank: int, error_tol: float | None = None, return_pivots: bool = False):
        """Partial pivoted Cholesky factor L (*b, n, rank), and the pivots
        with ``return_pivots`` (see ``functions.pivoted_cholesky``)."""
        from ..functions import pivoted_cholesky

        return pivoted_cholesky(self, rank, error_tol=error_tol, return_pivots=return_pivots)

    def _getitem(self, row_index, col_index, *batch_indices) -> "LinearOperator":
        """K[*batch_indices, row_index, col_index] as an operator, for slices
        or index tensors (dense fallback; structured subclasses override)."""
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense()[(*batch_indices, row_index, col_index)])

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """K[*batch_indices, row_index, col_index] elementwise over broadcast
        index tensors (dense fallback; structured subclasses override)."""
        return self.to_dense()[(*batch_indices, row_index, col_index)]

    def _select_cols(self, idx: torch.Tensor) -> "LinearOperator":
        """K[..., :, idx] (dense fallback; structured subclasses override)."""
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense()[..., :, idx])


def to_linear_operator(obj) -> LinearOperator:
    """An operator as it is; a tensor as a DenseLinearOperator."""
    from .dense import DenseLinearOperator

    return obj if isinstance(obj, LinearOperator) else DenseLinearOperator(torch.as_tensor(obj))
