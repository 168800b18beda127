from .contour_integral_quad import contour_integral_quad
from .lanczos import lanczos_tridiag, lanczos_tridiag_to_diag
from .linear_cg import linear_cg
from .minres import minres
from .pivoted_cholesky import pivoted_cholesky, pivoted_cholesky_with_pivots
from .stochastic_lq import StochasticLQ, slq_quadrature

__all__ = [
    "StochasticLQ",
    "contour_integral_quad",
    "lanczos_tridiag",
    "lanczos_tridiag_to_diag",
    "linear_cg",
    "minres",
    "pivoted_cholesky",
    "pivoted_cholesky_with_pivots",
    "slq_quadrature",
]
