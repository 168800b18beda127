from .lanczos import lanczos_tridiag_to_diag
from .linear_cg import linear_cg
from .stochastic_lq import slq_quadrature

__all__ = ["lanczos_tridiag_to_diag", "linear_cg", "slq_quadrature"]
