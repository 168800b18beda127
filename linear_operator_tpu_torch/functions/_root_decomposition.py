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

On a mesh (``parallel/``; ``sharding.solve_layout``) the start vector is
drawn for the whole batch and n and cut to the rank's block.  On a
row-sharded operator Lanczos sums its inner products over the model
group, so that every rank builds the unsharded T and its k x k
eigendecomposition: the root, the inverse root and ``diagonalization``'s
vectors are the rank's rows of the unsharded ones (on the Cholesky and
symeig routes, the rows of the whole factor every rank computes,
``_comm.own_rows``).  The backward's contractions over n (S^T S) are row
sums, and the operator's gradient shares are summed once over the model
group (``SolveLayout.reduce_grads``), as ``solve``'s are.
"""

from __future__ import annotations

import torch

from .. import settings
from ..solvers.lanczos import lanczos_tridiag
from ..utils.cholesky import highest_matmul_precision
from ..utils.random import randn


def _draw(op, shape: tuple, generator: torch.Generator | None, rows: bool = False) -> torch.Tensor:
    """N(0, I) of (*b, *shape) in the operator's dtype.  On a mesh the whole
    batch is drawn (with ``rows``, the last dim the whole n) and the rank's
    block kept, so that its draws are its block of the unsharded ones."""
    from ..parallel.sharding import solve_layout

    layout = solve_layout(op)
    if layout is None:
        return randn((*op.batch_shape, *shape), op.dtype, op.device, generator)
    whole = randn((*layout.batch, *shape), op.dtype, op.device, generator)
    return layout.draw_block(whole[None], rows=True)[0] if rows else layout.block(whole, rows=False)


def _random_start(op, generator: torch.Generator | None) -> torch.Tensor:
    """N(0, I) Lanczos start vectors (*b, n) in the operator's dtype (on a
    mesh: the rank's block of the whole draw)."""
    return _draw(op, (op.shape[-1],), generator, rows=True)


def _row_sum(op, name: str = "lanczos"):
    """The sum over a row-sharded operator's model group, else None."""
    group = getattr(op, "row_group", None)
    if group is None:
        return None
    from ..parallel import _comm

    return lambda t: _comm.all_reduce(t, group, name=name)


def _own_rows(op, whole: torch.Tensor) -> torch.Tensor:
    """A row-sharded operator's rows of a whole (*b, n, k) factor that every
    rank computes alike (the Cholesky and symeig routes); else ``whole``."""
    if getattr(op, "row_group", None) is None:
        return whole
    from ..parallel import _comm

    return _comm.own_rows(whole, op.row_group, op.sizes)


def _op_grads(op, left: torch.Tensor, right: torch.Tensor) -> tuple:
    """The operator's gradients of sum(left * (K @ right)); on a
    row-sharded operator (the rank's rows of both) its shares summed once
    over the model group."""
    from ..parallel.sharding import solve_layout

    grads = op._bilinear_derivative(left, right)
    layout = solve_layout(op)
    return grads if layout is None else layout.reduce_grads(grads)


def _lanczos_root_impl(op, init: torch.Tensor, k: int, want_inverse: bool = True):
    """(root, inverse root or None) from k Lanczos steps started at ``init``
    ((*b, n), or (p, *b, n) for p probes, which broadcast through
    ``op._matmul``)."""
    Q, T = lanczos_tridiag(op._matmul, k, init_vecs=init, row_sum=_row_sum(op), n=op.shape[-1])
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
        return (None, None, None, None, *_op_grads(ctx.op, left, right))


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
        # with P = S S^T S (S^T S a row sum on a row-sharded operator)
        row_sum = _row_sum(ctx.op, "root_grad") or (lambda t: t)
        with highest_matmul_precision():
            p = inv_root @ row_sum(inv_root.mT @ inv_root)
        left = torch.cat([0.25 * root_bar, 0.25 * inv_root, -0.25 * p, -0.25 * inv_bar], dim=-1)
        right = torch.cat([inv_root, root_bar, inv_bar, p], dim=-1)
        return (None, None, None, *_op_grads(ctx.op, left, right))


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
        chol = op._cholesky_impl(upper=False)
        if getattr(op, "row_group", None) is None:
            return CholLinearOperator(chol)
        return RootLinearOperator(DenseLinearOperator(_own_rows(op, chol.to_dense())))
    if method in ("symeig", "diagonalization"):
        evals, evecs = torch.linalg.eigh(op.to_dense())
        root = evecs * torch.sqrt(torch.clamp_min(evals, 0.0))[..., None, :]
        return RootLinearOperator(DenseLinearOperator(_own_rows(op, root)))
    if method == "lanczos":
        root, _ = _lanczos_root(op, generator, need_inverse=False)
        return RootLinearOperator(DenseLinearOperator(root))
    raise ValueError(f"unknown root_decomposition method {method!r}")


def _postprocess_lanczos_root_inv_decomp(op, inv_roots: torch.Tensor, test_vectors: torch.Tensor) -> torch.Tensor:
    """The best of p candidate inverse roots (p, *b, n, k) by the residual
    test: argmin_p sum |K R_p R_p^T t - t| over the test vectors (*b, n, t)
    (on a row-sharded operator, the rank's rows: the sums over n are row
    sums).  The index stays on the device; gradients reach only the
    winner."""
    row_sum = _row_sum(op) or (lambda t: t)
    with highest_matmul_precision():
        solves = inv_roots @ row_sum(inv_roots.mT @ test_vectors)
    resid = torch.sqrt(row_sum(torch.sum((op._matmul(solves) - test_vectors) ** 2, dim=-2)))  # (p, *b, t)
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
            # a row-sharded operator takes this rank's rows
            rows = op.rows.shape[-2] if getattr(op, "row_group", None) is not None else op.shape[-1]
            if initial_vectors.shape[-2] != rows:
                raise RuntimeError(
                    f"initial_vectors shape {tuple(initial_vectors.shape)} incompatible with operator {op.shape}"
                )

    structural = op._root_inv_structure()
    if structural is not None and method is None:
        return RootLinearOperator(structural)

    if method is None:
        method = op._choose_root_method()
    if method == "cholesky":
        root = op._cholesky_impl(upper=False).inverse()._transpose()  # L^{-T}
        if getattr(op, "row_group", None) is not None:
            root = DenseLinearOperator(_own_rows(op, root.to_dense()))  # the rank's rows
        return RootLinearOperator(root)
    if method in ("symeig", "diagonalization"):
        evals, evecs = torch.linalg.eigh(op.to_dense())
        inv_sqrt = torch.where(evals > 1e-12, torch.rsqrt(torch.clamp_min(evals, 1e-12)), 0.0)
        return RootLinearOperator(DenseLinearOperator(_own_rows(op, evecs * inv_sqrt[..., None, :])))
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
        return evals, DenseLinearOperator(_own_rows(op, evecs))
    if method == "lanczos":
        k = min(settings.max_root_decomposition_size.value(), n)
        Q, T = lanczos_tridiag(op._matmul, k, init_vecs=_random_start(op, generator), row_sum=_row_sum(op), n=n)
        evals, evecs = torch.linalg.eigh(T)
        with highest_matmul_precision():
            return torch.clamp_min(evals, 0.0), DenseLinearOperator(Q @ evecs)
    raise ValueError(f"unknown diagonalization method {method!r}")
