"""Exception taxonomy (counterpart of linear_operator_tpu/utils/errors.py)."""


class CachingError(RuntimeError):
    """A cache entry was requested that does not exist."""


class NanError(RuntimeError):
    """NaN encountered in a numerical routine."""


class NotPSDError(RuntimeError):
    """An operation requiring positive (semi-)definiteness was invoked on an
    operator that is not PSD."""
