from .lanczos import lanczos_tridiag, lanczos_tridiag_to_diag
from .linear_cg import linear_cg
from .pivoted_cholesky import pivoted_cholesky, pivoted_cholesky_with_pivots
from .stochastic_lq import slq_quadrature

__all__ = [
    "lanczos_tridiag",
    "lanczos_tridiag_to_diag",
    "linear_cg",
    "pivoted_cholesky",
    "pivoted_cholesky_with_pivots",
    "slq_quadrature",
]
