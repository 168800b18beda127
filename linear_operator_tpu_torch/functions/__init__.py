from ._inv_quad_logdet import inv_quad_logdet
from ._solve import solve


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


__all__ = ["inv_quad_logdet", "pivoted_cholesky", "solve"]
