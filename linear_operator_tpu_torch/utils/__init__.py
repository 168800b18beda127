from . import getitem, permutation, sparse
from . import sparse as interpolation
from .cholesky import psd_safe_cholesky
from .errors import CachingError, NanError, NotPSDError
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
    "getitem",
    "permutation",
    "psd_safe_cholesky",
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
