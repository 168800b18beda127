from ._inv_quad_logdet import inv_quad_logdet
from ._root_decomposition import diagonalization, root_decomposition, root_inv_decomposition
from ._solve import solve, solve_base


def inv_quad(op, rhs, reduce_inv_quad: bool = True, *, generator=None):
    """rhs^T K^{-1} rhs, summed over the columns with ``reduce_inv_quad``."""
    iq, _ = inv_quad_logdet(op, rhs, logdet=False, reduce_inv_quad=reduce_inv_quad, generator=generator)
    return iq


def pivoted_cholesky(op, rank: int, error_tol=None, return_pivots: bool = False):
    """Partial pivoted Cholesky L (*b, n, rank), with the pivots (*b, rank)
    when ``return_pivots``.

    Honours ``settings.pivoted_cholesky_block_size`` (the blocked sweep,
    forward-only) when it is above 1 and no pivots are asked for; otherwise
    the strict greedy, which is differentiable."""
    from .. import settings
    from ..solvers.pivoted_cholesky import pivoted_cholesky as _solver_pivoted_cholesky
    from ..solvers.pivoted_cholesky import pivoted_cholesky_with_pivots

    if not return_pivots and (settings.pivoted_cholesky_block_size.value() or 0) > 1:
        return _solver_pivoted_cholesky(op, rank, error_tol)
    L, pivots = pivoted_cholesky_with_pivots(op, rank, error_tol)
    return (L, pivots) if return_pivots else L


def add_diagonal(op, diag):
    return op.add_diagonal(diag)


def add_jitter(op, jitter_val: float = 1e-3):
    return op.add_jitter(jitter_val)


def sqrt_inv_matmul(op, rhs, lhs=None, *, generator=None):
    """K^{-1/2} rhs by contour integral quadrature; with ``lhs``, the pair
    (lhs @ K^{-1/2} rhs, the row-wise lhs K^{-1} lhs^T).  ``generator`` draws
    the Lanczos start of the eigenvalue-range estimate (a fixed one when
    None)."""
    from ._sqrt_inv_matmul import sqrt_inv_matmul as _impl

    return _impl(op, rhs, lhs, generator=generator)


def sqrt_matmul_ciq(op, rhs, *, generator=None):
    """K^{1/2} rhs by contour integral quadrature (CIQ sampling)."""
    from ._sqrt_inv_matmul import sqrt_matmul as _impl

    return _impl(op, rhs, generator=generator)


def dsmm(sparse, dense):
    """Batched sparse @ dense: an ``InterpolationMatrix`` by gather and
    scatter-add (``utils.sparse.bdsmm``), anything else by a dense product."""
    from ..utils.sparse import bdsmm

    return bdsmm(sparse, dense)


__all__ = [
    "add_diagonal",
    "add_jitter",
    "diagonalization",
    "dsmm",
    "inv_quad",
    "inv_quad_logdet",
    "pivoted_cholesky",
    "root_decomposition",
    "root_inv_decomposition",
    "solve",
    "solve_base",
    "sqrt_inv_matmul",
    "sqrt_matmul_ciq",
]
