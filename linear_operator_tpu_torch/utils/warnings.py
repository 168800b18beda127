"""Warning taxonomy (counterpart of linear_operator_tpu/utils/warnings.py)."""

import warnings

import torch


class NumericalWarning(RuntimeWarning):
    """Numerical issue: CG non-convergence, jittered Cholesky, clamped eigenvalues."""


class PerformanceWarning(RuntimeWarning):
    """An operation fell back to a slow path (e.g. densifying a lazy operator)."""


def debug_nan_check(name: str, arr: torch.Tensor) -> None:
    """``settings.debug``-gated NaN detector for solver inputs.

    Warns (NumericalWarning) when ``arr`` holds a NaN; the NaNs still
    propagate to the outputs, as in the JAX package.  On a CUDA tensor the
    check waits for the device once.
    """
    from .. import settings

    if settings.debug.on() and bool(torch.isnan(arr).any()):
        warnings.warn(
            f"NaN encountered in the input of {name}; results will be NaN.",
            NumericalWarning,
        )
