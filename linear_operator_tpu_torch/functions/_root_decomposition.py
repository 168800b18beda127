"""Root decompositions: K = R R^T (and K^{-1} = S S^T) (counterpart of
linear_operator_tpu/functions/_root_decomposition.py).

Dispatch: a closed-form root of the operator's structure, else the method
the caller names or ``_choose_root_method`` picks: dense Cholesky, a dense
eigendecomposition ("symeig"), or Lanczos, whose k = max_root_decomposition_size
steps call ``op._matmul`` (on the fused kernel path, one K3 launch a step).

Backward of the Lanczos roots (the JAX package's custom VJP): with K = R R^T
and the pseudo-inverse root S (S^T = R^+),

    K_bar =  1/2 sym(R_bar S^T)              (root cotangent)
          -  1/2 sym((S S^T S) S_bar^T)      (inverse-root cotangent)

pushed to the operator's tensors through ONE ``_bilinear_derivative`` over
stacked left and right vectors: 2k columns for the root, 4k with the
inverse root.  The backward's outputs carry no graph, so a second
derivative raises, as for ``solve``.

The random start vector comes from ``generator`` (a CPU generator seeded 0
when None: successive calls share it), drawn on the generator's device and
moved to the operator's.
"""

from __future__ import annotations

import torch

from .. import settings
from ..solvers.lanczos import lanczos_tridiag
from ..utils.cholesky import highest_matmul_precision
from ..utils.random import randn


def _random_start(op, generator: torch.Generator | None) -> torch.Tensor:
    """N(0, I) Lanczos start vectors (*b, n) in the operator's dtype."""
    return randn((*op.batch_shape, op.shape[-1]), op.dtype, op.device, generator)


def _lanczos_root_impl(op, init: torch.Tensor, k: int, want_inverse: bool = True):
    """(root, inverse root or None) from k Lanczos steps started at ``init``
    ((*b, n), or (p, *b, n) for p probes, which broadcast through
    ``op._matmul``)."""
    Q, T = lanczos_tridiag(op._matmul, k, init_vecs=init)
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    # in T's own dtype, as the JAX package does
    evals, evecs = torch.linalg.eigh(T + settings.tridiagonal_jitter.value() * eye)
    evals = torch.clamp_min(evals, 0.0)
    sqrt_evals = torch.sqrt(evals)
    with highest_matmul_precision():
        root = Q @ (evecs * sqrt_evals[..., None, :])
        if not want_inverse:
            return root, None
        inv_sqrt = torch.where(evals > 1e-12, 1.0 / torch.clamp_min(sqrt_evals, 1e-12), 0.0)
        return root, Q @ (evecs * inv_sqrt[..., None, :])


class _LanczosRoot(torch.autograd.Function):
    """The root alone; its backward needs the inverse root, which the forward
    computes only when a gradient will be taken."""

    @staticmethod
    def forward(ctx, op, init, k, want_grad, *op_leaves):
        root, inv_root = _lanczos_root_impl(op, init, k, want_inverse=want_grad)
        ctx.op = op
        ctx.save_for_backward(inv_root)
        return root

    @staticmethod
    def backward(ctx, root_bar):
        (inv_root,) = ctx.saved_tensors
        left = torch.cat([0.25 * root_bar, 0.25 * inv_root], dim=-1)
        right = torch.cat([inv_root, root_bar], dim=-1)
        return (None, None, None, None, *ctx.op._bilinear_derivative(left, right))


class _LanczosRootInv(torch.autograd.Function):
    """The root and the inverse root."""

    @staticmethod
    def forward(ctx, op, init, k, *op_leaves):
        root, inv_root = _lanczos_root_impl(op, init, k)
        ctx.op = op
        ctx.save_for_backward(inv_root)
        return root, inv_root

    @staticmethod
    def backward(ctx, root_bar, inv_bar):
        (inv_root,) = ctx.saved_tensors
        # K_bar = 1/4 (R_bar S^T + S R_bar^T) - 1/4 (P S_bar^T + S_bar P^T)
        # with P = S S^T S
        with highest_matmul_precision():
            p = inv_root @ (inv_root.mT @ inv_root)
        left = torch.cat([0.25 * root_bar, 0.25 * inv_root, -0.25 * p, -0.25 * inv_bar], dim=-1)
        right = torch.cat([inv_root, root_bar, inv_bar, p], dim=-1)
        return (None, None, None, *ctx.op._bilinear_derivative(left, right))


def _lanczos_root(op, generator, need_inverse: bool, init: torch.Tensor | None = None):
    """(root, inverse root) by Lanczos, the inverse root None unless
    ``need_inverse``: the two backwards differ in width (2k or 4k columns),
    so the choice is made here, not from which cotangents arrive."""
    k = min(settings.max_root_decomposition_size.value(), op.shape[-1])
    if init is None:
        init = _random_start(op, generator)
    leaves = tuple(op._leaves())
    if need_inverse:
        return _LanczosRootInv.apply(op, init, k, *leaves)
    want_grad = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    return _LanczosRoot.apply(op, init, k, want_grad, *leaves), None


def root_decomposition(op, method: str | None = None, *, generator: torch.Generator | None = None):
    """An operator equal to ``op`` carrying a root R with K = R R^T."""
    from ..operators.chol import CholLinearOperator
    from ..operators.dense import DenseLinearOperator
    from ..operators.root import RootLinearOperator
    from ..operators.triangular import TriangularLinearOperator

    if settings.debug.on() and not op.is_square:
        raise RuntimeError("root_decomposition requires a square operator")

    structural = op._root_structure()
    if structural is not None and method is None:
        if isinstance(structural, TriangularLinearOperator):
            return CholLinearOperator(structural)
        return RootLinearOperator(structural)

    if method is None:
        method = op._choose_root_method()
    if method == "cholesky":
        return CholLinearOperator(op._cholesky_impl(upper=False))
    if method in ("symeig", "diagonalization"):
        evals, evecs = torch.linalg.eigh(op.to_dense())
        return RootLinearOperator(DenseLinearOperator(evecs * torch.sqrt(torch.clamp_min(evals, 0.0))[..., None, :]))
    if method == "lanczos":
        root, _ = _lanczos_root(op, generator, need_inverse=False)
        return RootLinearOperator(DenseLinearOperator(root))
    raise ValueError(f"unknown root_decomposition method {method!r}")


def _postprocess_lanczos_root_inv_decomp(op, inv_roots: torch.Tensor, test_vectors: torch.Tensor) -> torch.Tensor:
    """The best of p candidate inverse roots (p, *b, n, k) by the residual
    test: argmin_p sum |K R_p R_p^T t - t| over the test vectors (*b, n, t).
    The index stays on the device; gradients reach only the winner."""
    with highest_matmul_precision():
        solves = inv_roots @ (inv_roots.mT @ test_vectors)
    resid = torch.linalg.norm(op._matmul(solves) - test_vectors, dim=-2)  # (p, *b, t)
    best = torch.argmin(resid.reshape(resid.shape[0], -1).sum(dim=-1))
    return torch.index_select(inv_roots, 0, best.reshape(1))[0]


def root_inv_decomposition(
    op,
    method: str | None = None,
    *,
    generator: torch.Generator | None = None,
    initial_vectors: torch.Tensor | None = None,
    test_vectors: torch.Tensor | None = None,
):
    """An operator equal to ``op^{-1}`` carrying a root.

    ``initial_vectors`` (*b, n, p) are the Lanczos start vectors; with p > 1
    every probe runs (one batched loop) and the best inverse root is picked
    by the ``test_vectors`` residual test (default: ``initial_vectors``)."""
    from ..operators.dense import DenseLinearOperator
    from ..operators.root import RootLinearOperator

    if settings.debug.on():
        if not op.is_square:
            raise RuntimeError("root_inv_decomposition requires a square operator")
        if initial_vectors is not None:
            if initial_vectors.ndim == 1:
                raise RuntimeError("initial_vectors must be (*b, n, p)")
            if initial_vectors.shape[-2] != op.shape[-1]:
                raise RuntimeError(
                    f"initial_vectors shape {tuple(initial_vectors.shape)} incompatible with operator {op.shape}"
                )

    structural = op._root_inv_structure()
    if structural is not None and method is None:
        return RootLinearOperator(structural)

    if method is None:
        method = op._choose_root_method()
    if method == "cholesky":
        return RootLinearOperator(op._cholesky_impl(upper=False).inverse()._transpose())  # L^{-T}
    if method in ("symeig", "diagonalization"):
        evals, evecs = torch.linalg.eigh(op.to_dense())
        inv_sqrt = torch.where(evals > 1e-12, torch.rsqrt(torch.clamp_min(evals, 1e-12)), 0.0)
        return RootLinearOperator(DenseLinearOperator(evecs * inv_sqrt[..., None, :]))
    if method == "lanczos":
        init = None
        if initial_vectors is not None:
            init = torch.movedim(initial_vectors, -1, 0)  # (p, *b, n)
            if init.shape[0] == 1:
                init = init[0]
        _, inv_root = _lanczos_root(op, generator, need_inverse=True, init=init)
        if initial_vectors is not None and initial_vectors.shape[-1] > 1:
            tv = test_vectors if test_vectors is not None else initial_vectors
            inv_root = _postprocess_lanczos_root_inv_decomp(op, inv_root, tv)
        return RootLinearOperator(DenseLinearOperator(inv_root))
    raise ValueError(f"unknown root_inv_decomposition method {method!r}")


def diagonalization(op, method: str | None = None, *, generator: torch.Generator | None = None):
    """(evals, evecs) with K ~= Q diag(evals) Q^T, Q a DenseLinearOperator."""
    from ..operators.dense import DenseLinearOperator

    if settings.debug.on() and not op.is_square:
        raise RuntimeError("diagonalization requires a square operator")
    n = op.shape[-1]
    if method is None:
        small = n <= settings.max_cholesky_size.value()
        method = "symeig" if small or settings.fast_computations.covar_root_decomposition.off() else "lanczos"
    if method == "symeig":
        evals, evecs = torch.linalg.eigh(op.to_dense())
        return evals, DenseLinearOperator(evecs)
    if method == "lanczos":
        k = min(settings.max_root_decomposition_size.value(), n)
        Q, T = lanczos_tridiag(op._matmul, k, init_vecs=_random_start(op, generator))
        evals, evecs = torch.linalg.eigh(T)
        with highest_matmul_precision():
            return torch.clamp_min(evals, 0.0), DenseLinearOperator(Q @ evecs)
    raise ValueError(f"unknown diagonalization method {method!r}")
