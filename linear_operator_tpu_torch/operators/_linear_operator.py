"""Abstract base class for lazy (batched) linear operators.

PyTorch counterpart of ``linear_operator_tpu/operators/_linear_operator.py``,
ported as far as the exact-GP slice needs it.  An operator represents a
(batch of) M x N matrix implicitly through ``_matmul``, ``_shape`` and
``_transpose``; everything else is built on them.

Operators are plain classes whose fields are tensors, nested operators or
static values.  ``_leaves`` walks the tensors and ``_map_tensors`` rebuilds a
copy with every tensor mapped (``detach`` is one such map; ``_with_leaves``,
the inverse of ``_leaves``, is another), which replaces the JAX package's
pytree flattening.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator

import torch

from .. import settings
from ..utils.broadcasting import matmul_broadcast_shape


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
        from .added_diag import AddedDiagLinearOperator
        from .diag import DiagLinearOperator
        from .sum import SumLinearOperator

        if isinstance(other, DiagLinearOperator):
            return AddedDiagLinearOperator(self, other)
        if isinstance(other, LinearOperator):
            return SumLinearOperator((self, other))
        raise NotImplementedError(
            f"{type(self).__name__} + {type(other).__name__} is not ported yet"
        )

    def add_diagonal(self, diag) -> "LinearOperator":
        """K + diag(d); a scalar or trailing-singleton ``diag`` becomes a
        ConstantDiagLinearOperator."""
        from .diag import diag_operator

        if not self.is_square:
            raise RuntimeError("add_diagonal requires a square operator")
        return self + diag_operator(diag, self)

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

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """K[*batch_indices, row_index, col_index] elementwise over broadcast
        index tensors (dense fallback; structured subclasses override)."""
        return self.to_dense()[(*batch_indices, row_index, col_index)]

    def _select_cols(self, idx: torch.Tensor) -> "LinearOperator":
        """K[..., :, idx] (dense fallback; structured subclasses override)."""
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense()[..., :, idx])

