from ..solvers import StochasticLQ
from ..solvers.contour_integral_quad import contour_integral_quad
from ..solvers.lanczos import lanczos_tridiag, lanczos_tridiag_to_diag
from ..solvers.linear_cg import linear_cg
from ..solvers.minres import minres
from . import broadcasting, cholesky, errors, getitem, permutation, qr, sparse, warnings
from . import qr as pinverse
from . import sparse as interpolation
from .cholesky import blocked_cholesky, psd_safe_cholesky, psd_safe_cholesky_ex
from .errors import CachingError, NanError, NotPSDError
from .qr import stable_pinverse, stable_qr
from .toeplitz import (
    sym_toeplitz,
    sym_toeplitz_derivative_quadratic_form,
    sym_toeplitz_getitem,
    sym_toeplitz_matmul,
    toeplitz,
    toeplitz_getitem,
    toeplitz_matmul,
)
from .warnings import NumericalWarning, PerformanceWarning

__all__ = [
    "StochasticLQ",
    "blocked_cholesky",
    "broadcasting",
    "cholesky",
    "contour_integral_quad",
    "errors",
    "getitem",
    "lanczos_tridiag",
    "lanczos_tridiag_to_diag",
    "linear_cg",
    "minres",
    "permutation",
    "pinverse",
    "psd_safe_cholesky",
    "psd_safe_cholesky_ex",
    "qr",
    "stable_pinverse",
    "stable_qr",
    "warnings",
    "CachingError",
    "NanError",
    "NotPSDError",
    "NumericalWarning",
    "PerformanceWarning",
    "interpolation",
    "sparse",
    "sym_toeplitz",
    "sym_toeplitz_derivative_quadratic_form",
    "sym_toeplitz_getitem",
    "sym_toeplitz_matmul",
    "toeplitz",
    "toeplitz_getitem",
    "toeplitz_matmul",
]
