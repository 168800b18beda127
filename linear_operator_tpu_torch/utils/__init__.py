from .cholesky import psd_safe_cholesky
from .errors import CachingError, NanError, NotPSDError
from .warnings import NumericalWarning, PerformanceWarning

__all__ = [
    "psd_safe_cholesky",
    "CachingError",
    "NanError",
    "NotPSDError",
    "NumericalWarning",
    "PerformanceWarning",
]
