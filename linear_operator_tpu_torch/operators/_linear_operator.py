"""Abstract base class for lazy (batched) linear operators.

PyTorch counterpart of ``linear_operator_tpu/operators/_linear_operator.py``.
An operator represents a (batch of) M x N matrix implicitly through
``_matmul``, ``_shape`` and ``_transpose``; everything else is built on them.

Operators are plain classes whose fields are tensors, nested operators or
static values.  ``_leaves`` walks the tensors and ``_map_tensors`` rebuilds a
copy with every tensor mapped (``detach`` is one such map; ``_with_leaves``,
the inverse of ``_leaves``, is another), which replaces the JAX package's
pytree flattening.
"""

from __future__ import annotations

import copy
import math
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

    def size(self, dim: int | None = None):
        """The shape (``torch.Size``-style), or its entry at ``dim``."""
        return self.shape if dim is None else self.shape[dim]

    def dim(self) -> int:
        return self.ndim

    def ndimension(self) -> int:
        return self.ndim

    @property
    def batch_dim(self) -> int:
        """The number of batch dimensions."""
        return len(self.batch_shape)

    def numel(self) -> int:
        """The number of entries of the dense equivalent."""
        return math.prod(self.shape)

    def __len__(self) -> int:
        if self.ndim <= 2:
            raise TypeError("len() of an unbatched operator")
        return self.shape[0]

    @property
    def _inherently_triangular(self) -> bool:
        """True when the operator is triangular by construction (a Kronecker
        product of triangular or diagonal factors), so that a
        TriangularLinearOperator around it keeps its structured paths."""
        return False

    def _parts(self) -> Iterator:
        """The tensor fields and nested operators, in field order (a nested
        operator is not walked into)."""

        def walk(value):
            if isinstance(value, (torch.Tensor, LinearOperator)):
                yield value
            elif isinstance(value, tuple):
                for v in value:
                    yield from walk(v)
            elif isinstance(value, dict):
                for v in value.values():
                    yield from walk(v)

        for value in vars(self).values():
            yield from walk(value)

    @property
    def dtype(self) -> torch.dtype:
        # a nested operator answers for itself: one whose only tensors are
        # indices (Permutation) or that has none (Identity) carries its dtype
        dtypes = [
            p.dtype for p in self._parts() if isinstance(p, LinearOperator) or p.is_floating_point() or p.is_complex()
        ]
        if not dtypes:
            return torch.get_default_dtype()
        out = dtypes[0]
        for dt in dtypes[1:]:
            out = torch.promote_types(out, dt)
        return out

    @property
    def device(self) -> torch.device | None:
        # a tensor's, else a nested operator's (Identity and Zero hold none)
        for t in self._leaves():
            return t.device
        for p in self._parts():
            if p.device is not None:
                return p.device
        return None

    @property
    def mT(self) -> "LinearOperator":
        return self._transpose()

    @property
    def T(self) -> "LinearOperator":
        if self.ndim != 2:
            raise RuntimeError("Use .mT for batched operators")
        return self._transpose()

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape}, dtype={self.dtype})"

    def representation(self) -> tuple[torch.Tensor, ...]:
        """The operator's tensors, in ``_leaves`` order."""
        return tuple(self._leaves())

    def detach(self) -> "LinearOperator":
        """Copy with every tensor detached from autograd."""
        return self._map_tensors(torch.Tensor.detach)

    def detach_(self) -> "LinearOperator":
        """In place: every tensor field detached from autograd; returns self."""
        self.__dict__.update(vars(self.detach()))
        return self

    def requires_grad_(self, value: bool = True) -> "LinearOperator":
        """In place: every floating tensor that is a leaf of autograd made to
        require grad (or not); returns self."""
        for t in self._leaves():
            if (t.is_floating_point() or t.is_complex()) and t.is_leaf:
                t.requires_grad_(value)
        return self

    def clone(self) -> "LinearOperator":
        return self._map_tensors(torch.Tensor.clone)

    def astype(self, dtype) -> "LinearOperator":
        """Every floating tensor cast to ``dtype``; index tensors stay."""

        def cast(t: torch.Tensor) -> torch.Tensor:
            return t.to(dtype) if (t.is_floating_point() or t.is_complex()) else t

        return self._map_tensors(cast)

    def float(self) -> "LinearOperator":
        return self.astype(torch.float32)

    def double(self) -> "LinearOperator":
        return self.astype(torch.float64)

    def half(self) -> "LinearOperator":
        return self.astype(torch.float16)

    def bfloat16(self) -> "LinearOperator":
        return self.astype(torch.bfloat16)

    def numpy(self):
        """The dense matrix as a numpy array (on the host, detached)."""
        return self.to_dense().detach().cpu().numpy()

    def evaluate_kernel(self) -> "LinearOperator":
        """The operator rebuilt from its tensors: a lazy operator here is
        already what a kernel evaluates to."""
        return self._map_tensors(lambda t: t)

    def type(self, dtype=None):
        """The dtype without an argument; a cast with one."""
        return self.dtype if dtype is None else self.astype(dtype)

    def to(self, *args, **kwargs) -> "LinearOperator":
        """``Tensor.to`` on every tensor: a device moves them all, a dtype
        casts the floating ones (index tensors keep their dtype)."""
        dtype, device = kwargs.pop("dtype", None), kwargs.pop("device", None)
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            else:
                device = a
        out = self if device is None else self._map_tensors(lambda t: t.to(device, **kwargs))
        return out if dtype is None else out.astype(dtype)

    def cpu(self) -> "LinearOperator":
        return self.to("cpu")

    def cuda(self, device=None) -> "LinearOperator":
        return self.to(torch.device("cuda", device) if isinstance(device, int) else (device or "cuda"))

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
        (None, None, None).  Under ``beta_features.default_preconditioner``
        an operator without a preconditioner of its own gets the randomized
        rangefinder one."""
        from .. import beta_features

        if (
            beta_features.default_preconditioner.on()
            and self.is_square
            and self.shape[-1] >= settings.min_preconditioning_size.value()
        ):
            return beta_features.build_default_preconditioner(
                self.detach(), rank=settings.max_preconditioner_size.value()
            )
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

    def matmul(self, other):
        """K @ other: a tensor for a tensor, the lazy product for an
        operator."""
        from .matmul import MatmulLinearOperator

        if isinstance(other, LinearOperator):
            return MatmulLinearOperator(self, other)
        if other.ndim == 1:
            return self._matmul(other[..., None])[..., 0]
        if settings.debug.on():
            matmul_broadcast_shape(self.shape, tuple(other.shape))
        return self._matmul(other)

    def rmatmul(self, other):
        """other @ K."""
        if isinstance(other, LinearOperator):
            return other.matmul(self)
        if other.ndim == 1:
            return self._t_matmul(other[..., None])[..., 0]
        return self._t_matmul(other.mT).mT

    def __matmul__(self, other):
        return self.matmul(other)

    def __rmatmul__(self, other):
        return self.rmatmul(other)

    def __add__(self, other):
        """Structure-dispatching sum: a diagonal gives an AddedDiag (or the
        subclass's own structure), a root operator a low-rank update, another
        operator a lazy sum, a scalar a dense operator, a tensor a lazy sum
        with it."""
        from .added_diag import AddedDiagLinearOperator
        from .dense import DenseLinearOperator
        from .diag import DiagLinearOperator
        from .root import RootLinearOperator
        from .sum import SumLinearOperator
        from .zero import ZeroLinearOperator

        if isinstance(other, ZeroLinearOperator):
            return self
        if isinstance(other, DiagLinearOperator):
            return AddedDiagLinearOperator(self, other)
        if isinstance(other, RootLinearOperator):
            # the root stays lazy: a structured root keeps its mat-vec
            return self.add_low_rank(other.root)
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

    def sub(self, other, alpha: float | None = None) -> "LinearOperator":
        """``self - alpha * other``."""
        return self - other if alpha is None else self - other * alpha

    def div(self, other) -> "LinearOperator":
        """``self * (1 / other)``."""
        from .zero import ZeroLinearOperator

        if isinstance(other, ZeroLinearOperator):
            raise RuntimeError("Attempted to divide by a ZeroLinearOperator")
        return self.mul(1.0 / torch.as_tensor(other, dtype=self.dtype, device=self.device))

    def t(self) -> "LinearOperator":
        if self.ndim != 2:
            raise RuntimeError("Cannot call t for more than 2 dimensions")
        return self._transpose()

    def mul(self, other) -> "LinearOperator":
        """Elementwise product: with a scalar, a batch-shaped tensor or one
        whose matrix dims are (1, 1), a ConstantMulLinearOperator; with an
        operator or a full-size tensor, the Hadamard product of root
        decompositions (MulLinearOperator)."""
        from .constant_mul import ConstantMulLinearOperator
        from .dense import DenseLinearOperator
        from .mul import MulLinearOperator

        if isinstance(other, LinearOperator):
            return MulLinearOperator.from_operators(self, other)
        const = torch.as_tensor(other, dtype=self.dtype, device=self.device)
        unit_matrix = const.ndim >= 2 and tuple(const.shape[-2:]) == (1, 1)
        if const.ndim == 0 or unit_matrix or const.ndim <= self.ndim - 2:
            # ConstantMul holds a batch-shaped constant and appends the
            # (1, 1) matrix dims itself
            return ConstantMulLinearOperator(self, const[..., 0, 0] if unit_matrix else const)
        return MulLinearOperator.from_operators(self, DenseLinearOperator(const))

    def __mul__(self, other):
        return self.mul(other)

    def __rmul__(self, other):
        return self.mul(other)

    def __truediv__(self, other):
        return self.mul(1.0 / torch.as_tensor(other, dtype=self.dtype, device=self.device))

    # Elementwise spectrum and entry functions: only operators whose structure
    # allows them (Diag, Identity) implement these.
    def abs(self) -> "LinearOperator":
        raise NotImplementedError(f"abs({type(self).__name__}) is not implemented.")

    def exp(self) -> "LinearOperator":
        raise NotImplementedError(f"exp({type(self).__name__}) is not implemented.")

    def log(self) -> "LinearOperator":
        raise NotImplementedError(f"log({type(self).__name__}) is not implemented.")

    def sqrt(self) -> "LinearOperator":
        raise NotImplementedError(f"sqrt({type(self).__name__}) is not implemented.")

    def inverse(self) -> "LinearOperator":
        raise NotImplementedError(
            f"inverse({type(self).__name__}) is not implemented; "
            "use solve(rhs) for matrix-free application of the inverse."
        )

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

    def add_low_rank(self, low_rank_mat, generate_roots: bool = True) -> "LinearOperator":
        """K + V V^T.  When K carries a root R (``_carried_root``) and
        ``generate_roots``, the result is the RootLinearOperator of [R | V];
        otherwise a lazy sum, and no root is computed."""
        from .dense import DenseLinearOperator
        from .root import RootLinearOperator
        from .sum import SumLinearOperator

        if isinstance(low_rank_mat, LinearOperator):
            # a structured root stays lazy: its mat-vec carries the structure
            v_op = low_rank_mat
        else:
            v = torch.as_tensor(low_rank_mat, dtype=self.dtype, device=self.device)
            v_op = DenseLinearOperator(v[:, None] if v.ndim == 1 else v)
        root = self._carried_root() if generate_roots else None
        if root is not None:
            return RootLinearOperator(DenseLinearOperator(torch.cat([root.to_dense(), v_op.to_dense()], dim=-1)))
        return SumLinearOperator((self, RootLinearOperator(v_op)))

    def cat_rows(self, cross_mat, new_mat, generate_roots: bool = True) -> "LinearOperator":
        """Append m rows and columns to a PSD operator: ``cross_mat`` is the
        new rows (*b, m, n), ``new_mat`` the new block C (*b, m, m), so that

            K' = [[K,   B],
                  [B^T, C]]   with B = cross_mat^T.

        When K carries a root R and ``generate_roots``, the result carries
        the block-triangular root [[R, 0], [B^T R^{-T}, S]] with S S^T the
        Schur complement C - B^T K^{-1} B; otherwise it is the lazy
        Cat-of-Cat block operator, and no root is computed."""
        from ..functions import solve
        from ..utils.cholesky import psd_safe_cholesky
        from .cat import CatLinearOperator
        from .dense import DenseLinearOperator
        from .root import RootLinearOperator

        B = torch.as_tensor(cross_mat, dtype=self.dtype, device=self.device).mT
        C = torch.as_tensor(new_mat, dtype=self.dtype, device=self.device)
        root_op = self._carried_root() if generate_roots else None
        if root_op is None:
            top = CatLinearOperator((self, DenseLinearOperator(B)), cat_dim=-1)
            bottom = CatLinearOperator((DenseLinearOperator(B.mT), DenseLinearOperator(C)), cat_dim=-1)
            return CatLinearOperator((top, bottom), cat_dim=-2)

        R = root_op.to_dense()  # (*b, n, k)
        m = C.shape[-1]
        KinvB = solve(self, B)  # (*b, n, m)
        lower_left = KinvB.mT @ R  # B^T K^{-1} R = B^T R^{-T}
        schur = C - B.mT @ KinvB
        S = psd_safe_cholesky((schur + schur.mT) / 2.0)
        top = torch.cat([R, torch.zeros((*R.shape[:-1], m), dtype=R.dtype, device=R.device)], dim=-1)
        bottom = torch.cat([lower_left, S], dim=-1)
        return RootLinearOperator(DenseLinearOperator(torch.cat([top, bottom], dim=-2)))

    def trace(self) -> torch.Tensor:
        return torch.sum(self._diagonal(), dim=-1)

    # ------------------------------------------------------------------
    # Solves, quadratic forms, log-determinants (see ``functions``)
    # ------------------------------------------------------------------

    def solve(self, rhs: torch.Tensor, lhs: torch.Tensor | None = None, *, factored=None) -> torch.Tensor:
        """K^{-1} rhs, or lhs @ K^{-1} rhs; ``factored`` reuses a
        factorization (see :meth:`with_factorization`)."""
        from ..functions import solve

        return solve(self, rhs, lhs, factored=factored)

    def with_factorization(self, factor: "LinearOperator") -> "LinearOperator":
        """The operator through which later solves, log-determinants and
        samples should go, given a factorization of this one (``cholesky()``,
        a root decomposition): a triangular factor L becomes
        CholLinearOperator(L) = L L^T, a factor-carrying operator passes
        through.  Gradients reach the original tensors through the
        factorization's own."""
        factor = self._wrap_factor(factor)
        if settings.debug.on() and tuple(factor.shape) != tuple(self.shape):
            raise RuntimeError(f"factorization shape {factor.shape} != operator shape {self.shape}")
        return factor

    @staticmethod
    def _wrap_factor(factor: "LinearOperator") -> "LinearOperator":
        from .chol import CholLinearOperator
        from .triangular import TriangularLinearOperator

        if isinstance(factor, TriangularLinearOperator):
            return CholLinearOperator(factor._transpose() if factor.upper else factor)
        return factor

    def _carried_root(self) -> "LinearOperator | None":
        """The root this operator carries as its own data (Root, LowRankRoot,
        Chol), or None.  ``add_low_rank`` and ``cat_rows`` update such a root
        but never compute one: a merely computable root (a Kronecker factor's,
        a diagonal's square root) does not count."""
        from .chol import CholLinearOperator
        from .root import RootLinearOperator

        if isinstance(self, (RootLinearOperator, CholLinearOperator)):
            return self._root_structure()
        return None

    def solve_triangular(self, rhs: torch.Tensor, *, upper: bool, left: bool = True):
        """Defined for triangular operators only."""
        raise NotImplementedError(
            f"solve_triangular({type(self).__name__}) is not implemented; only triangular operators support it."
        )

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
        factored=None,
    ):
        """(rhs^T K^{-1} rhs, log|K|) from one batched solve; ``factored``
        reuses a factorization (see :meth:`with_factorization`)."""
        from ..functions import inv_quad_logdet

        return inv_quad_logdet(
            self,
            inv_quad_rhs,
            logdet=logdet,
            reduce_inv_quad=reduce_inv_quad,
            generator=generator,
            factored=factored,
        )

    def logdet(self, *, generator: torch.Generator | None = None) -> torch.Tensor:
        _, ld = self.inv_quad_logdet(None, logdet=True, generator=generator)
        return ld

    def log_det(self, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """Deprecated spelling of :meth:`logdet`."""
        warnings.warn("log_det is deprecated; use logdet", DeprecationWarning, stacklevel=2)
        return self.logdet(generator=generator)

    def inv_quad_log_det(
        self,
        inv_quad_rhs: torch.Tensor | None = None,
        logdet: bool = False,
        reduce_inv_quad: bool = True,
        *,
        generator: torch.Generator | None = None,
    ):
        """Deprecated spelling of :meth:`inv_quad_logdet`."""
        warnings.warn("inv_quad_log_det is deprecated; use inv_quad_logdet", DeprecationWarning, stacklevel=2)
        return self.inv_quad_logdet(inv_quad_rhs, logdet=logdet, reduce_inv_quad=reduce_inv_quad, generator=generator)
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

    def reshape(self, *sizes) -> "LinearOperator":
        """:meth:`expand`, with reshape's leading -1 accepted."""
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list, torch.Size)):
            sizes = tuple(sizes[0])
        if len(sizes) == self.ndim + 1 and sizes[0] == -1:
            sizes = (1,) + tuple(sizes[1:])
        return self.expand(*sizes)

    def repeat(self, *sizes) -> "LinearOperator":
        """Lazy tiling of the batch dims; the matrix dims take (1, 1)."""
        from .batch_repeat import BatchRepeatLinearOperator

        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list, torch.Size)):
            sizes = tuple(sizes[0])
        if len(sizes) < 2 or sizes[-1] != 1 or sizes[-2] != 1:
            raise RuntimeError("repeat on an operator requires trailing (1, 1) for matrix dims")
        return BatchRepeatLinearOperator(self, batch_repeat=tuple(sizes[:-2]))

    def _unsqueeze_batch(self, dim: int) -> "LinearOperator":
        """Dense fallback; structured subclasses reshape their tensors."""
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense().unsqueeze(dim))

    def unsqueeze(self, dim: int) -> "LinearOperator":
        if dim < 0:
            dim = dim + self.ndim + 1
        if dim > self.ndim - 2:
            raise RuntimeError("cannot unsqueeze into matrix dims")
        return self._unsqueeze_batch(dim)

    def squeeze(self, dim: int) -> "LinearOperator":
        if self.shape[dim] != 1:
            return self
        index = [slice(None)] * self.ndim
        index[dim] = 0
        return self[tuple(index)]

    def _permute_batch(self, *dims: int) -> "LinearOperator":
        """Dense fallback; structured subclasses permute their tensors."""
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense().permute(*dims, self.ndim - 2, self.ndim - 1))

    def permute(self, *dims: int) -> "LinearOperator":
        """Permutes the batch dims; a full-length permutation must keep the
        matrix dims last."""
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = tuple(dims[0])
        num_batch = self.ndim - 2
        # negative dims count from the full ndim in a full-length permutation
        offset = self.ndim if len(dims) == self.ndim else num_batch
        dims = tuple(d + offset if -self.ndim <= d < 0 else d for d in dims)
        if len(dims) == self.ndim:
            if dims[-2:] != (self.ndim - 2, self.ndim - 1):
                raise RuntimeError("permute cannot move matrix dims")
            dims = dims[:-2]
        if sorted(dims) != list(range(num_batch)):
            raise RuntimeError(f"invalid batch permutation {dims}")
        return self._permute_batch(*dims)

    def transpose(self, dim0: int, dim1: int) -> "LinearOperator":
        ndim = self.ndim
        dim0, dim1 = dim0 % ndim, dim1 % ndim
        if dim0 == dim1:
            return self
        matrix_dims = {ndim - 2, ndim - 1}
        if {dim0, dim1} == matrix_dims:
            return self._transpose()
        if dim0 in matrix_dims or dim1 in matrix_dims:
            raise RuntimeError("cannot transpose a batch dim with a matrix dim")
        perm = list(range(ndim - 2))
        perm[dim0], perm[dim1] = perm[dim1], perm[dim0]
        return self._permute_batch(*perm)

    def sum(self, dim: int | None = None):
        """Over a batch dim, a lazy SumBatchLinearOperator; over a matrix dim
        or everything, a tensor."""
        if dim is None:
            return torch.sum(self.to_dense())
        ndim = self.ndim
        dim = dim % ndim
        if dim >= ndim - 2:
            return torch.sum(self.to_dense(), dim=dim - ndim)
        from .sum_batch import SumBatchLinearOperator

        num_batch = ndim - 2
        perm = [d for d in range(num_batch) if d != dim] + [dim]
        moved = self._permute_batch(*perm) if perm != list(range(num_batch)) else self
        return SumBatchLinearOperator(moved, block_dim=-3)

    def prod(self, dim: int, *, lazy: bool = False):
        """Elementwise product over a batch dim: exact and dense by default;
        with ``lazy``, the divide-and-conquer product of root decompositions,
        which stays a lazy MulLinearOperator (PSD batches only)."""
        ndim = self.ndim
        dim = dim % ndim
        if dim >= ndim - 2:
            raise RuntimeError("prod over matrix dims is not defined")
        if lazy:
            return self._prod_batch(dim)
        from .dense import DenseLinearOperator

        return DenseLinearOperator(torch.prod(self.to_dense(), dim=dim))

    def _prod_batch(self, dim: int) -> "LinearOperator":
        """Pairs of roots combine through MulLinearOperator's row-wise
        Khatri-Rao product; an odd count is padded with the exact rank-1
        all-ones root."""
        from .dense import DenseLinearOperator
        from .mul import MulLinearOperator

        if self.shape[dim] == 1:
            return self.squeeze(dim)
        roots = self.root_decomposition().root.to_dense()
        num_batch = roots.shape[dim]
        while True:
            if num_batch % 2:
                pad_shape = list(roots.shape)
                pad_shape[dim] = 1
                ones_root = torch.zeros(pad_shape, dtype=roots.dtype, device=roots.device)
                ones_root[..., 0] = 1.0
                roots = torch.cat([roots, ones_root], dim=dim)
                num_batch += 1
            half = num_batch // 2
            part1 = roots.narrow(dim, 0, half)
            part2 = roots.narrow(dim, half, half)
            if half == 1:
                return MulLinearOperator(DenseLinearOperator(part1.squeeze(dim)), DenseLinearOperator(part2.squeeze(dim)))
            roots = MulLinearOperator(DenseLinearOperator(part1), DenseLinearOperator(part2))._root_structure().to_dense()
            num_batch = half

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

        dense = self.to_dense()
        # on the card, cuSOLVER's QR-based gesvd: the default Jacobi
        # iterations stop at ~1e-4 reconstruction error in f32
        U, S, Vt = torch.linalg.svd(dense, full_matrices=False, driver="gesvd" if dense.is_cuda else None)
        return DenseLinearOperator(U), S, DenseLinearOperator(Vt.mT)

    def pivoted_cholesky(self, rank: int, error_tol: float | None = None, return_pivots: bool = False):
        """Partial pivoted Cholesky factor L (*b, n, rank), and the pivots
        with ``return_pivots`` (see ``functions.pivoted_cholesky``)."""
        from ..functions import pivoted_cholesky

        return pivoted_cholesky(self, rank, error_tol=error_tol, return_pivots=return_pivots)

    # ------------------------------------------------------------------
    # Indexing
    # ------------------------------------------------------------------

    def _getitem(self, row_index, col_index, *batch_indices) -> "LinearOperator":
        """K[*batch_indices, row_index, col_index] as an operator, for slices
        or index tensors (dense fallback; structured subclasses override)."""
        from .dense import DenseLinearOperator

        return DenseLinearOperator(self.to_dense()[(*batch_indices, row_index, col_index)])

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        """K[*batch_indices, row_index, col_index] elementwise over broadcast
        index tensors (dense fallback; structured subclasses override)."""
        return self.to_dense()[(*batch_indices, row_index, col_index)]

    def _select_rows(self, idx: torch.Tensor) -> "LinearOperator":
        """Lazy K[..., idx, :] for a 1-D index tensor: the operator between
        one-hot interpolation matrices, so that a matrix-free operator stays
        matrix-free (structured subclasses override)."""
        from .interpolated import InterpolatedLinearOperator

        m = self.shape[-1]
        li = torch.as_tensor(idx, device=self.device).reshape(-1, 1)
        ri = torch.arange(m, device=self.device)[:, None]
        lv = torch.ones(li.shape, dtype=self.dtype, device=self.device)
        rv = torch.ones((m, 1), dtype=self.dtype, device=self.device)
        return InterpolatedLinearOperator(self, li, lv, ri, rv)

    def _select_cols(self, idx: torch.Tensor) -> "LinearOperator":
        """Lazy K[..., :, idx] (see ``_select_rows``)."""
        return self._transpose()._select_rows(idx)._transpose()

    def __getitem__(self, index):
        """Tensor-style indexing (``utils.getitem``): slices give lazy
        operators, a 1-D index tensor on one matrix dim a lazy selection,
        index tensors on both matrix dims dense values."""
        from ..utils.getitem import normalize_getitem_index

        return normalize_getitem_index(self, index)

    def isclose(self, other, rtol: float = 1e-5, atol: float = 1e-8) -> torch.Tensor:
        other_dense = other.to_dense() if isinstance(other, LinearOperator) else torch.as_tensor(other)
        return torch.isclose(self.to_dense(), other_dense.to(self.device), rtol=rtol, atol=atol)


def to_dense(obj) -> torch.Tensor:
    """An operator densified; a tensor as it is."""
    return obj.to_dense() if isinstance(obj, LinearOperator) else torch.as_tensor(obj)


def to_linear_operator(obj) -> LinearOperator:
    """An operator as it is; a tensor as a DenseLinearOperator."""
    from .dense import DenseLinearOperator

    return obj if isinstance(obj, LinearOperator) else DenseLinearOperator(torch.as_tensor(obj))
