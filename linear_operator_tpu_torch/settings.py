"""Context-manager settings that select algorithms and tolerances.

PyTorch counterpart of ``linear_operator_tpu/settings.py``: the same flag
inventory with the same defaults.  Three base classes mirror the reference's
``_feature_flag``, ``_value_context`` and ``_dtype_value_context``.

The port runs eagerly, so a value is read when the code that consults it
runs; a change takes effect on the next call.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

logger = logging.getLogger("linear_operator_tpu_torch")


class _feature_flag:
    """Boolean context-manager flag."""

    _default: bool = False
    _state: bool | None = None

    def __init__(self, state: bool = True):
        self.state = state

    @classmethod
    def is_default(cls) -> bool:
        return cls._state is None

    @classmethod
    def on(cls) -> bool:
        return cls._default if cls._state is None else cls._state

    @classmethod
    def off(cls) -> bool:
        return not cls.on()

    @classmethod
    def _set_state(cls, state: bool | None) -> None:
        cls._state = state

    def __enter__(self):
        self.prev = type(self)._state
        self._set_state(self.state)
        return self

    def __exit__(self, *exc):
        self._set_state(self.prev)
        return False


class _value_context:
    """Scalar-valued context manager."""

    _global_value: Any = None

    def __init__(self, value: Any):
        self._value = value

    @classmethod
    def value(cls) -> Any:
        return cls._global_value

    @classmethod
    def _set_value(cls, value: Any) -> None:
        cls._global_value = value

    def __enter__(self):
        self._prev = type(self)._global_value
        self._set_value(self._value)
        return self

    def __exit__(self, *exc):
        self._set_value(self._prev)
        return False


class _dtype_value_context:
    """Per-dtype scalar values."""

    _global_float16_value: float | None = None
    _global_bfloat16_value: float | None = None
    _global_float32_value: float | None = None
    _global_float64_value: float | None = None

    def __init__(self, float16=None, bfloat16=None, float32=None, float64=None):
        self._values = (float16, bfloat16, float32, float64)

    @classmethod
    def value(cls, dtype=None) -> float:
        if dtype is None:
            dtype = torch.float32
        if dtype == torch.float16:
            return cls._global_float16_value
        if dtype == torch.bfloat16:
            return cls._global_bfloat16_value
        if dtype == torch.float32:
            return cls._global_float32_value
        if dtype == torch.float64:
            return cls._global_float64_value
        raise RuntimeError(f"Unsupported dtype for {cls.__name__}: {dtype}")

    def __enter__(self):
        cls = type(self)
        self._prev = (
            cls._global_float16_value,
            cls._global_bfloat16_value,
            cls._global_float32_value,
            cls._global_float64_value,
        )
        new = tuple(
            v if v is not None else p for v, p in zip(self._values, self._prev)
        )
        (
            cls._global_float16_value,
            cls._global_bfloat16_value,
            cls._global_float32_value,
            cls._global_float64_value,
        ) = new
        return self

    def __exit__(self, *exc):
        cls = type(self)
        (
            cls._global_float16_value,
            cls._global_bfloat16_value,
            cls._global_float32_value,
            cls._global_float64_value,
        ) = self._prev
        return False


class _composite:
    """Enters several contexts together and leaves them in reverse order."""

    _ctxs: tuple = ()

    def __enter__(self):
        for ctx in self._ctxs:
            ctx.__enter__()
        return self

    def __exit__(self, *exc):
        for ctx in reversed(self._ctxs):
            ctx.__exit__(*exc)
        return False


# ---------------------------------------------------------------------------
# Flag inventory — defaults match linear_operator_tpu/settings.py.
# ---------------------------------------------------------------------------


class cg_tolerance(_value_context):
    """Relative residual to stop CG."""

    _global_value = 1.0


class cholesky_jitter(_dtype_value_context):
    """Jitter added on Cholesky retry."""

    _global_float16_value = 1e-3
    _global_bfloat16_value = 1e-3
    _global_float32_value = 1e-6
    _global_float64_value = 1e-8


class cholesky_max_tries(_value_context):
    """Escalating-jitter attempts."""

    _global_value = 3


class ciq_samples(_feature_flag):
    """Sample MVNs (``zero_mean_mvn_samples``) by contour integral quadrature."""

    _default = False


class debug(_feature_flag):
    """Extra argument validation and NaN checks."""

    _default = True


class deterministic_probes(_feature_flag):
    """Declare that a call without ``generator=`` may reuse the fixed-seed
    probe draw (silences the warning in ``inv_quad_logdet``)."""

    _default = False
    probe_vectors = None


class _fast_covar_root_decomposition(_feature_flag):
    _default = True


class _fast_log_prob(_feature_flag):
    _default = True


class _fast_solves(_feature_flag):
    _default = True


class fast_computations(_composite):
    """Composite flag.

    ``covar_root_decomposition``: Lanczos vs Cholesky/symeig roots.
    ``log_prob``: SLQ/stochastic logdet vs exact Cholesky logdet.
    ``solves``: preconditioned CG vs Cholesky solves.
    """

    covar_root_decomposition = _fast_covar_root_decomposition
    log_prob = _fast_log_prob
    solves = _fast_solves

    def __init__(self, covar_root_decomposition=True, log_prob=True, solves=True):
        self._ctxs = (
            _fast_covar_root_decomposition(covar_root_decomposition),
            _fast_log_prob(log_prob),
            _fast_solves(solves),
        )


class _linalg_dtype_symeig(_value_context):
    """Internal dtype of the small tridiagonal eigensolves of SLQ
    (``solvers.lanczos.lanczos_tridiag_to_diag``).  Default float64."""

    _global_value = torch.float64


class _linalg_dtype_cholesky(_value_context):
    _global_value = torch.float64


class linalg_dtypes(_composite):
    """Context manager over both internal linalg dtypes."""

    symeig = _linalg_dtype_symeig
    cholesky = _linalg_dtype_cholesky

    def __init__(self, default=torch.float64, symeig=None, cholesky=None):
        self._ctxs = (
            _linalg_dtype_symeig(symeig if symeig is not None else default),
            _linalg_dtype_cholesky(cholesky if cholesky is not None else default),
        )


class max_cg_iterations(_value_context):
    _global_value = 1000


class max_cholesky_size(_value_context):
    """Below this N, solve/logdet use Cholesky, not CG."""

    _global_value = 800


class max_lanczos_quadrature_iterations(_value_context):
    """Tridiagonal size for SLQ quadrature."""

    _global_value = 20


class max_preconditioner_size(_value_context):
    """Preconditioner rank."""

    _global_value = 15


class preconditioner_mode(_value_context):
    """CG preconditioner construction for AddedDiag operators.

    "pivoted" (default): greedy pivoted Cholesky of rank
    ``max_preconditioner_size`` (``solvers/pivoted_cholesky.py``).
    "nystrom": uniformly strided Nystrom factor of rank
    ``max_preconditioner_size``.  "auto": Nystrom with rank
    ``clip(n // 64, 50, 400)``, never below ``max_preconditioner_size``.
    """

    _global_value = "pivoted"


class max_root_decomposition_size(_value_context):
    _global_value = 100


class memory_efficient(_feature_flag):
    """Recompute kernel blocks every solver iteration instead of caching a
    dense K per solve (``KernelLinearOperator._matmul_closure``)."""

    _default = False


class min_preconditioning_size(_value_context):
    """Only precondition above this N."""

    _global_value = 2000


class minres_tolerance(_value_context):
    _global_value = 1e-4


class num_contour_quadrature(_value_context):
    _global_value = 15


class num_trace_samples(_value_context):
    """Hutchinson probe count for SLQ."""

    _global_value = 10


class preconditioner_tolerance(_value_context):
    _global_value = 1e-3


class skip_logdet_forward(_feature_flag):
    """Return 0 for the SLQ logdet term in the forward."""

    _default = False


class terminate_cg_by_size(_feature_flag):
    """Run CG exactly N iterations."""

    _default = False


class trace_mode(_feature_flag):
    """Inert; kept for API parity."""

    _default = False


class tridiagonal_jitter(_value_context):
    _global_value = 1e-6


class use_toeplitz(_feature_flag):
    _default = True


class pivoted_cholesky_block_size(_value_context):
    _global_value = 0


class toeplitz_fft_min_size(_value_context):
    _global_value = 4096


class verbose_linalg(_feature_flag):
    """Debug-log every expensive linalg call, and the CG iteration count."""

    _default = False

    @classmethod
    def logger(cls):
        return logger


class stable_qr_host_threshold(_value_context):
    """Inert; kept for API parity."""

    _global_value = 128


stable_qr_cpu_threshold = stable_qr_host_threshold


class tpu_profile(_composite):
    """The operating point the JAX package recommends for stochastic MLL
    work, kept under its name for parity: 15 quadrature iterations, 64
    probes and the "auto" preconditioner."""

    def __init__(self):
        self._ctxs = (
            max_lanczos_quadrature_iterations(15),
            num_trace_samples(64),
            preconditioner_mode("auto"),
        )


def use_cholesky_for_solves(n: int) -> bool:
    """True when ``solve`` takes the direct Cholesky path instead of CG."""
    return n <= max_cholesky_size.value() or fast_computations.solves.off()


def use_cholesky_for_log_prob(n: int) -> bool:
    """True when ``inv_quad_logdet`` takes the exact Cholesky path instead of
    stochastic CG + SLQ."""
    return n <= max_cholesky_size.value() or fast_computations.log_prob.off()


def record_linalg(name: str, *shapes) -> None:
    """Hook used by solvers when ``verbose_linalg`` is on."""
    if verbose_linalg.on():
        logger.debug("Running %s on shapes %s", name, tuple(tuple(s) for s in shapes))
