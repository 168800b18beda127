"""Kronecker-product operators: K = K_1 (x) K_2 (x) ... (x) K_f (counterpart
of linear_operator_tpu/operators/kronecker.py).

The mat-vec is the reshape-multiply-permute sweep: the rhs is viewed as a
tensor over the factor dimensions and each factor's own ``_matmul`` is
applied along its axis, so factors keep their structure (a diagonal factor
multiplies in O(n), a Toeplitz factor takes its dense or FFT route) and each
factor contraction is one batched product of shape (n_i, m_i) x (m_i, rest).
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch

from ..utils.broadcasting import broadcast_shapes
from ._linear_operator import LinearOperator, to_linear_operator


def _kron_mm(factors, rhs: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """(x)_i K_i (or its transpose) applied to rhs (*b, prod(m_i), t) by the
    factor sweep."""
    m_sizes = [f.shape[-2] if transpose else f.shape[-1] for f in factors]
    batch = broadcast_shapes(tuple(rhs.shape[:-2]), *(tuple(f.batch_shape) for f in factors))
    t = rhs.shape[-1]
    x = rhs.expand(*batch, rhs.shape[-2], t).reshape(*batch, *m_sizes, t)
    nb = len(batch)
    for i, f in enumerate(factors):
        # bring factor i's axis to -2, fold the other factor axes into the
        # columns, run the factor's own product, restore the layout
        x = torch.movedim(x, nb + i, -2)
        mids = tuple(x.shape[nb:-2])
        m_i = x.shape[-2]
        x = x.reshape(*batch, math.prod(mids), m_i, t)
        x = torch.movedim(x, -3, -1).reshape(*batch, m_i, -1)  # (*batch, m_i, t * mid)
        y = f._t_matmul(x) if transpose else f._matmul(x)  # (*batch, n_i, t * mid)
        n_i = y.shape[-2]
        y = torch.movedim(y.reshape(*batch, n_i, t, -1), -1, -3)  # (*batch, mid, n_i, t)
        x = torch.movedim(y.reshape(*batch, *mids, n_i, t), -2, nb + i)
    out_sizes = [f.shape[-1] if transpose else f.shape[-2] for f in factors]
    return x.reshape(*batch, math.prod(out_sizes), t)


def _kron_vector(vectors) -> torch.Tensor:
    """The Kronecker product of per-factor vectors (*b, n_i) -> (*b, prod n_i)."""
    out = vectors[0]
    for v in vectors[1:]:
        batch = broadcast_shapes(tuple(out.shape[:-1]), tuple(v.shape[:-1]))
        out = (out[..., :, None] * v[..., None, :]).reshape(*batch, -1)
    return out


class _SolveAdapter:
    """A factor seen by ``_kron_mm`` through its solves."""

    def __init__(self, f, structured: bool = False):
        self.f = f
        self.shape = f.shape
        self.batch_shape = f.batch_shape
        self.structured = structured

    def _matmul(self, x):
        from ..functions import solve

        if self.structured:
            # a triangular factor's own solve, before the generic one
            s = self.f._solve_structure(x)
            return solve(self.f, x) if s is None else s
        return solve(self.f, x)

    def _t_matmul(self, x):
        from ..functions import solve

        return self._matmul(x) if self.structured else solve(self.f._transpose(), x)


def _factors(operators) -> tuple:
    """The constructor's factors: varargs, or one tuple or list of them;
    tensors become DenseLinearOperators."""
    if len(operators) == 1 and isinstance(operators[0], (tuple, list)):
        operators = tuple(operators[0])
    if len(operators) < 1:
        raise ValueError("needs at least one factor")
    return tuple(to_linear_operator(f) for f in operators)


class KroneckerProductLinearOperator(LinearOperator):
    def __init__(self, *operators):
        self.operators = _factors(operators)

    def _shape(self) -> tuple[int, ...]:
        batch = broadcast_shapes(*(tuple(f.batch_shape) for f in self.operators))
        n = math.prod(f.shape[-2] for f in self.operators)
        m = math.prod(f.shape[-1] for f in self.operators)
        return (*batch, n, m)

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return _kron_mm(self.operators, rhs)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return _kron_mm(self.operators, rhs, transpose=True)

    def _transpose(self) -> "KroneckerProductLinearOperator":
        return type(self)(tuple(f._transpose() for f in self.operators))

    def _diagonal(self) -> torch.Tensor:
        return _kron_vector([f._diagonal() for f in self.operators])

    def to_dense(self) -> torch.Tensor:
        out = self.operators[0].to_dense()
        for f in self.operators[1:]:
            d = f.to_dense()
            batch = broadcast_shapes(tuple(out.shape[:-2]), tuple(d.shape[:-2]))
            out = (out[..., :, None, :, None] * d[..., None, :, None, :]).reshape(
                *batch, out.shape[-2] * d.shape[-2], out.shape[-1] * d.shape[-1]
            )
        return out

    # -- structure-aware math ------------------------------------------------

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        """K^{-1} = (x) K_i^{-1}: the factors' solves in the same sweep."""
        return _kron_mm([_SolveAdapter(f) for f in self.operators], rhs)

    def _logdet_structure(self) -> torch.Tensor:
        """log|K| = sum_i (N / n_i) log|K_i|."""
        from ..functions import inv_quad_logdet

        n = self.shape[-1]
        total = None
        for f in self.operators:
            _, ld = inv_quad_logdet(f, None, logdet=True)
            term = (n // f.shape[-1]) * ld
            total = term if total is None else total + term
        return total

    def inverse(self) -> "KroneckerProductLinearOperator":
        return KroneckerProductLinearOperator(tuple(_factor_inverse(f) for f in self.operators))

    def _cholesky_impl(self, upper: bool = False) -> LinearOperator:
        """chol(K) = (x) chol(K_i)."""
        from .triangular import TriangularLinearOperator

        factors = tuple(f._cholesky_impl(upper=upper) for f in self.operators)
        return TriangularLinearOperator(KroneckerProductTriangularLinearOperator(factors, upper=upper), upper=upper)

    def _root_structure(self) -> "KroneckerProductLinearOperator":
        from ..functions import root_decomposition

        roots = []
        for f in self.operators:
            r = f._root_structure()
            roots.append(root_decomposition(f).root if r is None else r)
        return KroneckerProductLinearOperator(tuple(roots))

    def _root_inv_structure(self) -> "KroneckerProductLinearOperator":
        from ..functions import root_inv_decomposition

        inv_roots = []
        for f in self.operators:
            r = f._root_inv_structure()
            inv_roots.append(root_inv_decomposition(f).root if r is None else r)
        return KroneckerProductLinearOperator(tuple(inv_roots))

    def eigh(self):
        """Factor-wise symmetric eigendecomposition: evals = kron of the
        factors' evals, evecs = kron of their evecs.  Same-shape factors on
        the generic dense path go through one batched ``eigh_safe``."""
        from ..utils.eigh import eigh_safe
        from .dense import DenseLinearOperator

        results: list = [None] * len(self.operators)
        groups = defaultdict(list)
        for i, f in enumerate(self.operators):
            if type(f).eigh is LinearOperator.eigh:  # the generic dense path only
                groups[tuple(f.shape)].append(i)
        for idxs in groups.values():
            if len(idxs) < 2:
                continue
            ev, evec = eigh_safe(torch.stack([self.operators[i].to_dense() for i in idxs]))
            for k, i in enumerate(idxs):
                results[i] = (ev[k], DenseLinearOperator(evec[k]))
        for i, f in enumerate(self.operators):
            if results[i] is None:
                results[i] = f.eigh()
        evals = _kron_vector([r[0] for r in results])
        return evals, KroneckerProductLinearOperator(tuple(r[1] for r in results))

    def eigvalsh(self) -> torch.Tensor:
        return torch.sort(_kron_vector([f.eigvalsh() for f in self.operators]), dim=-1).values

    def _inv_quad_logdet_structure(self, rhs, logdet: bool):
        zeros = torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)
        iq = zeros if rhs is None else torch.sum(self._solve_structure(rhs) * rhs, dim=-2)
        ld = self._logdet_structure().expand(self.batch_shape) if logdet else zeros
        return iq, ld

    def __add__(self, other):
        from .diag import DiagLinearOperator
        from .kronecker_added_diag import KroneckerProductAddedDiagLinearOperator

        if isinstance(other, (KroneckerProductDiagLinearOperator, DiagLinearOperator)):
            return KroneckerProductAddedDiagLinearOperator(self, other)
        if (
            isinstance(other, KroneckerProductLinearOperator)
            and len(other.operators) == len(self.operators) == 2
        ):
            from .sum_kronecker import SumKroneckerLinearOperator

            return SumKroneckerLinearOperator((self, other))
        return super().__add__(other)

    def _expand_batch(self, batch_shape) -> "KroneckerProductLinearOperator":
        return self._replace(operators=tuple(f._expand_batch(batch_shape) for f in self.operators))

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        # (i, j) factors as mixed-radix digits over the factors' (n_i, m_i);
        # factors with a narrower batch are expanded to the product's first
        batch = self.batch_shape
        factors = [f._expanded_to(batch) for f in self.operators]
        sizes = [(f.shape[-2], f.shape[-1]) for f in factors]
        out = None
        for idx, f in enumerate(factors):
            n_i, m_i = sizes[idx]
            row_stride = math.prod(s[0] for s in sizes[idx + 1 :])
            col_stride = math.prod(s[1] for s in sizes[idx + 1 :])
            vals = f._get_indices((row_index // row_stride) % n_i, (col_index // col_stride) % m_i, *batch_indices)
            out = vals if out is None else out * vals
        return out


def _factor_inverse(f: LinearOperator) -> LinearOperator:
    if hasattr(f, "inverse"):
        try:
            return f.inverse()
        except (NotImplementedError, AttributeError):
            pass
    from .dense import DenseLinearOperator

    return DenseLinearOperator(torch.linalg.inv(f.to_dense()))


class KroneckerProductTriangularLinearOperator(KroneckerProductLinearOperator):
    """Kronecker product of triangular factors."""

    def __init__(self, *operators, upper: bool = False):
        super().__init__(*operators)
        self.upper = upper

    @property
    def _inherently_triangular(self) -> bool:
        return True

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        # the factors' triangular solves in the sweep
        return _kron_mm([_SolveAdapter(f, structured=True) for f in self.operators], rhs)

    def _cholesky_impl(self, upper: bool = False):
        from ..utils.errors import NotPSDError

        raise NotPSDError("triangular Kronecker product is not PSD")

    def _transpose(self) -> "KroneckerProductTriangularLinearOperator":
        return KroneckerProductTriangularLinearOperator(
            tuple(f._transpose() for f in self.operators), upper=not self.upper
        )


class KroneckerProductDiagLinearOperator(KroneckerProductLinearOperator):
    """Kronecker product of diagonal factors."""

    @property
    def _inherently_triangular(self) -> bool:
        return True

    def _solve_structure(self, rhs: torch.Tensor) -> torch.Tensor:
        return rhs / self._diagonal()[..., :, None]

    def _logdet_structure(self) -> torch.Tensor:
        n = self.shape[-1]
        total = None
        for f in self.operators:
            term = (n // f.shape[-1]) * torch.sum(torch.log(f._diagonal()), dim=-1)
            total = term if total is None else total + term
        return total

    def _diag_factors(self, fn) -> "KroneckerProductDiagLinearOperator":
        from .diag import DiagLinearOperator

        return KroneckerProductDiagLinearOperator(tuple(DiagLinearOperator(fn(f._diagonal())) for f in self.operators))

    def abs(self) -> "KroneckerProductDiagLinearOperator":
        # |kron(d_1, ..., d_f)| = kron(|d_1|, ..., |d_f|)
        return self._diag_factors(torch.abs)

    def inverse(self) -> "KroneckerProductDiagLinearOperator":
        return self._diag_factors(torch.reciprocal)

    def sqrt(self) -> "KroneckerProductDiagLinearOperator":
        return self._diag_factors(torch.sqrt)

    def _root_structure(self) -> "KroneckerProductDiagLinearOperator":
        return self.sqrt()

    def _root_inv_structure(self) -> "KroneckerProductDiagLinearOperator":
        return self.inverse().sqrt()

    def _cholesky_impl(self, upper: bool = False) -> LinearOperator:
        from .triangular import TriangularLinearOperator

        return TriangularLinearOperator(self.sqrt(), upper=upper)
