"""Fused stationary-kernel mat-vecs, written by hand in CUDA for Hopper.

PyTorch counterpart of ``linear_operator_tpu/ops/rbf.py``.  Two kernels
compute y = k(|x1_i - x2_j|^2) v without storing the kernel matrix:

* K1 :func:`kernel_matvec`, rectangular (``csrc/kernel_matvec.cu``), which
  replaces the Pallas kernel ``_pallas_matvec``;
* K3 :func:`kernel_matvec_sym`, for x1 = x2 (``csrc/kernel_matvec_sym.cu``),
  which forms each off-diagonal tile once and replaces
  ``_pallas_matvec_sym``.

Inputs are pre-scaled by the lengthscale and the result is scaled by the
outputscale outside the kernels, in PyTorch.  ``covar`` names a
``TILE_COVARS`` entry.

Each wrapper takes its kernel's plain PyTorch version (:func:`kernel_matvec_plain`)
for tensors on the CPU, launches the kernel for tensors on a CUDA device, and
raises for anything else.  ``<wrapper>.launches`` counts the kernel launches.
The kernels are forward-only: a backward through them raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from .. import _build
from ..utils.cholesky import highest_matmul_precision

_SQRT5 = 5.0**0.5
_SQRT3 = 3.0**0.5

# Column limit of K3, which keeps each tile's rhs rows in shared memory and
# its accumulators in registers; wider rhs go to K1.
SYM_MAX_COLUMNS = 16
MAX_DIM = 128  # input dimensions the kernels take (shared-memory sizing)
K1_SPLIT = 4096  # x2 points per K1 partial sum (MS in csrc/kernel_matvec.cu)

BACKWARD_SLICE = (
    "the backward of the fused kernel mat-vec (the K2 weighted-tile kernel and "
    "the backward halves of K1 and K3) is the next slice of the port, the GP "
    "training step; this slice is forward-only"
)


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (*b, n, m), exact in f32: summed squared
    differences for d <= 8, the quadratic form clamped at 0 otherwise."""
    d = x1.shape[-1]
    if d <= 8:
        d2 = None
        for k in range(d):
            diff = x1[..., :, None, k] - x2[..., None, :, k]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        return d2
    sq1 = torch.sum(x1 * x1, dim=-1)[..., :, None]
    sq2 = torch.sum(x2 * x2, dim=-1)[..., None, :]
    with highest_matmul_precision():
        inner = torch.matmul(x1, x2.mT)
    return torch.clamp_min(sq1 + sq2 - 2.0 * inner, 0.0)


def _covar_rbf(d2):
    return torch.exp(-0.5 * d2)


def _covar_matern52(d2):
    sd = _SQRT5 * torch.sqrt(d2 + 1e-30)
    return (1.0 + sd + (5.0 / 3.0) * d2) * torch.exp(-sd)


def _covar_matern32(d2):
    sd = _SQRT3 * torch.sqrt(d2 + 1e-30)
    return (1.0 + sd) * torch.exp(-sd)


def _covar_matern12(d2):
    return torch.exp(-torch.sqrt(d2 + 1e-30))


class TileCovar(NamedTuple):
    """A covariance k(d2) the kernels evaluate: its plain version, the id
    the CUDA sources switch on (``csrc/covar.cuh``), and its runtime
    parameter (alpha of the rational quadratic)."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    covar_id: int
    alpha: float = 0.0


TILE_COVARS: dict[str, TileCovar] = {
    "rbf": TileCovar(_covar_rbf, 0),
    "matern52": TileCovar(_covar_matern52, 1),
    "matern32": TileCovar(_covar_matern32, 2),
    "matern12": TileCovar(_covar_matern12, 3),
}
_COVAR_RQ = 4


def rq_tile_covar(alpha: float) -> str:
    """Register (idempotently) the rational quadratic ``(1 + d2 / (2 alpha))
    ^-alpha`` and return its key.  The kernels take ``alpha`` as a runtime
    float, so one build serves every alpha."""
    alpha = float(alpha)
    name = f"rq_{alpha!r}"
    if name not in TILE_COVARS:

        def _covar_rq(d2, _a=alpha):
            return (1.0 + d2 / (2.0 * _a)) ** (-_a)

        TILE_COVARS[name] = TileCovar(_covar_rq, _COVAR_RQ, alpha)
    return name


def kernel_matvec_plain(x1, x2, v, covar: str = "rbf", block_entries: int = 2**27) -> torch.Tensor:
    """Plain version of K1 and K3: k(sq_dist(x1, x2)) @ v in full precision,
    formed in row blocks of at most ``block_entries`` kernel entries."""
    fn = TILE_COVARS[covar].fn
    rows = max(1, block_entries // max(1, x2.shape[-2]))
    with highest_matmul_precision():
        out = [
            torch.matmul(fn(sq_dist(x1[..., s : s + rows, :], x2)), v)
            for s in range(0, x1.shape[-2], rows)
        ]
    return torch.cat(out, dim=-2)


class _ForwardOnly(torch.autograd.Function):
    """Runs ``impl(*args)``; a backward through it raises."""

    @staticmethod
    def forward(ctx, impl, *args):
        return impl(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(BACKWARD_SLICE)


def _as_batched(*tensors):
    if any(t.ndim not in (2, 3) for t in tensors):
        raise ValueError("expected (n, d) / (n, t) or (batch, n, d) / (batch, n, t) tensors")
    batched = tensors[0].ndim == 3
    if any((t.ndim == 3) != batched for t in tensors):
        raise ValueError("either all or none of the arguments carry a batch dim")
    return batched, [t if batched else t[None] for t in tensors]


def _on_cuda(*tensors) -> bool:
    """False when every tensor is on the CPU, True when all are on one CUDA
    device; raises otherwise."""
    devices = {t.device for t in tensors}
    if all(dev.type == "cpu" for dev in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the kernel takes tensors on one CUDA device, got {sorted(map(str, devices))}")
    return True


def _check_kernel_inputs(tensors, d: int) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"the kernels take 1 <= d <= {MAX_DIM}, got d={d}")


def _launch(library: str, symbol: str, argtypes, *args) -> None:
    fn = getattr(_build.load(library), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {err}")


_P = ctypes.c_void_p
_I = ctypes.c_int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def kernel_matvec(x1, x2, v, covar: str = "rbf") -> torch.Tensor:
    """K1: y = k(|x1_i - x2_j|^2) @ v, never storing the kernel matrix.

    x1 (*b, n, d), x2 (*b, m, d), v (*b, m, t) -> (*b, n, t), with at most
    one batch dim, which becomes a grid dimension of the kernel."""
    return _ForwardOnly.apply(_kernel_matvec, x1, x2, v, covar)


def _kernel_matvec(x1, x2, v, covar):
    if not _on_cuda(x1, x2, v):
        return kernel_matvec_plain(x1, x2, v, covar)
    spec = TILE_COVARS[covar]
    batched, (a, b, w) = _as_batched(x1, x2, v)
    nb, n, d = a.shape
    m, t = w.shape[-2:]
    if b.shape != (nb, m, d) or w.shape[0] != nb:
        raise ValueError(f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, v {tuple(v.shape)}")
    _check_kernel_inputs((a, b, w), d)
    # columns per CTA, 8, 16, 24 or 32: as few chunks as possible, each
    # rounded up to a multiple of 8 (t = 65 runs as 3 chunks of 24)
    tp = 8 * _cdiv(_cdiv(t, _cdiv(t, 32)), 8)
    # the kernel writes one partial result per split of K1_SPLIT x2 points
    partial = torch.empty((_cdiv(m, K1_SPLIT), nb, n, t), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _launch(
        "kernel_matvec", "kernel_matvec_f32",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        a.data_ptr(), b.data_ptr(), w.data_ptr(), partial.data_ptr(),
        nb, n, m, d, t, tp, spec.covar_id, spec.alpha, stream,
    )
    kernel_matvec.launches += 1
    out = partial[0] if partial.shape[0] == 1 else partial.sum(dim=0)
    return out if batched else out[0]


kernel_matvec.launches = 0


def sym_matvec_supported(t: int) -> bool:
    """The port's gate for K3: rhs of 1..SYM_MAX_COLUMNS columns."""
    return 1 <= t <= SYM_MAX_COLUMNS


def kernel_matvec_sym(x, v, covar: str = "rbf") -> torch.Tensor:
    """K3: y = k(|x_i - x_j|^2) @ v for the symmetric kernel matrix, forming
    each off-diagonal tile once.

    x (*b, n, d), v (*b, n, t) -> (*b, n, t), at most one batch dim;
    ``sym_matvec_supported(t)`` must hold."""
    return _ForwardOnly.apply(_kernel_matvec_sym, x, v, covar)


def _kernel_matvec_sym(x, v, covar):
    if not sym_matvec_supported(v.shape[-1]):
        raise ValueError(f"K3 takes 1..{SYM_MAX_COLUMNS} rhs columns, got {v.shape[-1]}")
    if not _on_cuda(x, v):
        return kernel_matvec_plain(x, x, v, covar)
    spec = TILE_COVARS[covar]
    batched, (a, w) = _as_batched(x, v)
    nb, n, d = a.shape
    t = w.shape[-1]
    if w.shape[:2] != (nb, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, v {tuple(v.shape)}")
    _check_kernel_inputs((a, w), d)
    if _cdiv(n, 128) > 65535 or nb > 65535:
        raise ValueError(f"K3 takes n <= {65535 * 128} and batch <= 65535")
    out_t = torch.zeros((nb, t, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _launch(
        "kernel_matvec_sym", "kernel_matvec_sym_f32",
        [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        a.data_ptr(), w.data_ptr(), out_t.data_ptr(),
        nb, n, d, t, spec.covar_id, spec.alpha, stream,
    )
    kernel_matvec_sym.launches += 1
    out = out_t.mT
    return out if batched else out[0]


kernel_matvec_sym.launches = 0
