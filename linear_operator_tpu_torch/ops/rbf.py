"""Fused stationary-kernel mat-vecs and their backward, written by hand in
CUDA for Hopper.

PyTorch counterpart of ``linear_operator_tpu/ops/rbf.py``.  Three kernels
that never store the kernel matrix:

* K1 :func:`kernel_matvec`, y = k(|x1_i - x2_j|^2) v, rectangular
  (``csrc/kernel_matvec.cu``), which replaces the Pallas kernel
  ``_pallas_matvec``;
* K3 :func:`kernel_matvec_sym`, the same for x1 = x2
  (``csrc/kernel_matvec_sym.cu``), which forms each off-diagonal tile once and
  replaces ``_pallas_matvec_sym``;
* K2 :func:`kernel_weighted`, W = k'(|x1_i - x2_j|^2) o (g v^T) reduced to
  W @ x2 and rowsum(W) (``csrc/kernel_weighted.cu``), which replaces
  ``_pallas_weighted``: the chain rule through the squared distance, which
  gives K1 and K3 their x-gradients;

and the two of the bf16 tile cache, which stores its upper triangle once per
solve:

* K4 :func:`rbf_build_sym_tiles` (``csrc/kernel_build_sym.cu``), the bf16
  upper-triangle tiles, which replaces ``rbf_build_sym_tiles``;
* K5 :func:`rbf_matvec_sym_cached` (``csrc/kernel_matvec_cached.cu``),
  bf16(K) v from those tiles, which replaces ``rbf_matvec_sym_cached``.

Inputs are pre-scaled by the lengthscale and the result is scaled by the
outputscale outside the kernels, in PyTorch.  ``covar`` names a
``TILE_COVARS`` entry.

K1 and K3 contract K v, and K2 forms g v^T, on the tensor cores as the
Pallas kernels do (``_dot_acc3``): three bf16 products with f32
accumulation; :func:`kernel_matvec_acc3_plain` and
:func:`kernel_weighted_acc3_plain` repeat that arithmetic in PyTorch.  K5
streams its bf16 tiles into the tensor cores, one product per bf16 part of v.

Each wrapper takes its kernel's plain PyTorch version (``*_plain``, for K1,
K2 and K3 the full-precision one) for tensors on the CPU, launches the kernel
for tensors on a CUDA device, and raises for anything else.  On the card the
kernels take every d and batch the JAX package takes, and K2 every t: a batch
above 65535 (a grid dimension) runs in groups and K2's columns above 128 in
chunks, one launch each (:func:`_in_groups`).  A covariance registered at
run time (:func:`register_tile_covar`) runs in the kernels when it was given
CUDA bodies, which are compiled into builds of its own, and raises on the
card when it was not.
``<wrapper>.launches`` counts the kernel launches and ``launches_by_covar``
the same by covariance id; :func:`reset_launch_counts` sets them to 0.
K1 and K3 are ``torch.autograd.Function``s whose backward is K2 (x-gradients)
and K1 / K3 (v-gradient), each computed only when its input needs it.
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
# Batch elements one launch of K1, K2 or K3 takes: the batch is a grid
# dimension (grid.y or grid.z), so a larger batch runs in groups
MAX_GRID_BATCH = 65535
# x2 points per partial sum of K1 and K2 (MS in csrc/kernel_matvec.cu and
# csrc/kernel_weighted.cu)
K1_SPLIT = 4096


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


def _dcovar_rbf(d2):
    return -0.5 * torch.exp(-0.5 * d2)


def _covar_matern52(d2):
    sd = _SQRT5 * torch.sqrt(d2 + 1e-30)
    return (1.0 + sd + (5.0 / 3.0) * d2) * torch.exp(-sd)


def _dcovar_matern52(d2):
    # d/d(d2) [(1 + sqrt5 d + 5/3 d^2) e^{-sqrt5 d}] = -(5/6)(1 + sqrt5 d) e^{-sqrt5 d}
    sd = _SQRT5 * torch.sqrt(d2 + 1e-30)
    return -(5.0 / 6.0) * (1.0 + sd) * torch.exp(-sd)


def _covar_matern32(d2):
    sd = _SQRT3 * torch.sqrt(d2 + 1e-30)
    return (1.0 + sd) * torch.exp(-sd)


def _dcovar_matern32(d2):
    # d/d(d2) [(1 + sqrt3 d) e^{-sqrt3 d}] = -(3/2) e^{-sqrt3 d}
    return -1.5 * torch.exp(-_SQRT3 * torch.sqrt(d2 + 1e-30))


def _covar_matern12(d2):
    return torch.exp(-torch.sqrt(d2 + 1e-30))


def _dcovar_matern12(d2):
    # -e^{-d} / (2 d) is singular at d = 0; a (near-)coincident pair gets
    # weight 0, the JAX package's convention, so that its huge weight does
    # not swamp the f32 sums of W @ x2 and rowsum(W)
    d = torch.sqrt(d2 + 1e-30)
    return torch.where(d2 > 1e-12, -torch.exp(-d) / (2.0 * d), torch.zeros_like(d))


class TileCovar(NamedTuple):
    """A covariance k(d2) the kernels evaluate: its plain version, the plain
    version of its derivative dk/d(d2), the id the CUDA sources switch on
    (``csrc/covar.cuh``; None for a covariance registered without CUDA
    bodies, which no kernel evaluates), its runtime parameter (alpha of the
    rational quadratic), and, for one registered with CUDA bodies, the
    header that compiles them into its builds (``_build.covar_header``)."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    dfn: Callable[[torch.Tensor], torch.Tensor]
    covar_id: int | None
    alpha: float = 0.0
    header: str = ""


TILE_COVARS: dict[str, TileCovar] = {
    "rbf": TileCovar(_covar_rbf, _dcovar_rbf, 0),
    "matern52": TileCovar(_covar_matern52, _dcovar_matern52, 1),
    "matern32": TileCovar(_covar_matern32, _dcovar_matern32, 2),
    "matern12": TileCovar(_covar_matern12, _dcovar_matern12, 3),
}
_COVAR_RQ = 4
_COVAR_USER = 5


def register_tile_covar(name: str, covar_fn, dcovar_fn, cuda_covar: str | None = None,
                        cuda_dcovar: str | None = None) -> str:
    """Register a stationary covariance ``k(d2)`` under ``name``, which then
    is a ``covar=`` key of every wrapper in this module; returns ``name``.

    ``covar_fn(d2) -> k`` and ``dcovar_fn(d2) -> dk/d(d2)`` are elementwise
    torch functions of the squared distance of inputs pre-scaled by the
    lengthscale: the plain versions, which CPU tensors take.  The kernels
    cannot evaluate a Python function, so for the card ``cuda_covar`` and
    ``cuda_dcovar`` give the same two functions as CUDA C++ expressions of
    the float ``d2`` (``"1.0f / (1.0f + d2)"``).  They are compiled into
    builds of K1-K4 of their own (id ``COVAR_USER`` of ``csrc/covar.cuh``;
    at first use, keyed by a hash of their text), as in the JAX package a
    registered covariance runs inside the Pallas kernels.  A covariance
    registered without them raises on CUDA tensors."""
    if (cuda_covar is None) != (cuda_dcovar is None):
        raise ValueError("give both cuda_covar and cuda_dcovar, or neither")
    if cuda_covar is None:
        TILE_COVARS[name] = TileCovar(covar_fn, dcovar_fn, None)
    else:
        header = _build.covar_header(cuda_covar, cuda_dcovar)
        TILE_COVARS[name] = TileCovar(covar_fn, dcovar_fn, _COVAR_USER, header=header)
    return name


def _card_spec(covar: str) -> TileCovar:
    """The covariance ``covar`` for a launch on the card; raises for one
    registered without CUDA bodies."""
    spec = TILE_COVARS[covar]
    if spec.covar_id is None:
        raise ValueError(
            f"the covariance {covar!r} was registered without CUDA bodies, so no kernel can evaluate it: "
            "give register_tile_covar cuda_covar= and cuda_dcovar=, or pass CPU tensors"
        )
    return spec


def _count_launch(wrapper, spec: TileCovar) -> None:
    """One launch of ``wrapper``'s kernel, in ``wrapper.launches`` and, by
    covariance id, in ``wrapper.launches_by_covar``."""
    wrapper.launches += 1
    wrapper.launches_by_covar[spec.covar_id] = wrapper.launches_by_covar.get(spec.covar_id, 0) + 1


def reset_launch_counts() -> None:
    """Every wrapper's counters set to 0: its launches and its launches by
    covariance id."""
    for wrapper in (kernel_matvec, kernel_matvec_sym, kernel_weighted, rbf_build_sym_tiles, rbf_matvec_sym_cached):
        wrapper.launches = 0
        wrapper.launches_by_covar = {}


def rq_tile_covar(alpha: float) -> str:
    """Register (idempotently) the rational quadratic ``(1 + d2 / (2 alpha))
    ^-alpha`` and return its key.  The kernels take ``alpha`` as a runtime
    float, so one build serves every alpha."""
    alpha = float(alpha)
    name = f"rq_{alpha!r}"
    if name not in TILE_COVARS:

        def _covar_rq(d2, _a=alpha):
            return (1.0 + d2 / (2.0 * _a)) ** (-_a)

        def _dcovar_rq(d2, _a=alpha):
            return -0.5 * (1.0 + d2 / (2.0 * _a)) ** (-_a - 1.0)

        TILE_COVARS[name] = TileCovar(_covar_rq, _dcovar_rq, _COVAR_RQ, alpha)
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


def dot_acc3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the JAX package's ``_dot_acc3`` computes it: three bf16
    products a_hi b_hi + a_hi b_lo + a_lo b_hi accumulated in f32, with hi =
    bf16(a) and lo = bf16(a - hi) rounded to nearest even.  The arithmetic of
    K1 and K3 on the card; the CPU path keeps the full-precision product."""
    ah, al = _split_bf16(a, 2)
    bh, bl = _split_bf16(b, 2)
    with highest_matmul_precision():
        return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


def kernel_matvec_acc3_plain(x1, x2, v, covar: str = "rbf", block_entries: int = 2**27) -> torch.Tensor:
    """Plain version of K1 and K3 in their own arithmetic: the tiles of
    :func:`kernel_matvec_plain`, contracted with :func:`dot_acc3`."""
    fn = TILE_COVARS[covar].fn
    rows = max(1, block_entries // max(1, x2.shape[-2]))
    out = [dot_acc3(fn(sq_dist(x1[..., s : s + rows, :], x2)), v) for s in range(0, x1.shape[-2], rows)]
    return torch.cat(out, dim=-2)


def kernel_weighted_plain(x1, x2, g, v, covar: str = "rbf", block_entries: int = 2**27):
    """Plain version of K2: (W @ x2, rowsum(W)) with W = k'(sq_dist(x1, x2))
    o (g v^T), in full precision, formed in row blocks of at most
    ``block_entries`` entries.  x1 (*b, n, d), x2 (*b, m, d), g (*b, n, t),
    v (*b, m, t) -> (*b, n, d), (*b, n)."""
    dfn = TILE_COVARS[covar].dfn
    rows = max(1, block_entries // max(1, x2.shape[-2]))
    wx, ws = [], []
    with highest_matmul_precision():
        for s in range(0, x1.shape[-2], rows):
            blk = slice(s, s + rows)
            w = dfn(sq_dist(x1[..., blk, :], x2)) * torch.matmul(g[..., blk, :], v.mT)
            wx.append(torch.matmul(w, x2))
            ws.append(torch.sum(w, dim=-1))
    return torch.cat(wx, dim=-2), torch.cat(ws, dim=-1)


def kernel_weighted_acc3_plain(x1, x2, g, v, covar: str = "rbf", block_entries: int = 2**27):
    """Plain version of K2 in its own arithmetic: :func:`kernel_weighted_plain`
    with g v^T contracted by :func:`dot_acc3`, as the TPU kernel's
    ``_dot_acc3`` and the card's three bf16 products compute it."""
    dfn = TILE_COVARS[covar].dfn
    rows = max(1, block_entries // max(1, x2.shape[-2]))
    wx, ws = [], []
    for s in range(0, x1.shape[-2], rows):
        blk = slice(s, s + rows)
        w = dfn(sq_dist(x1[..., blk, :], x2)) * dot_acc3(g[..., blk, :], v.mT)
        with highest_matmul_precision():
            wx.append(torch.matmul(w, x2))
        ws.append(torch.sum(w, dim=-1))
    return torch.cat(wx, dim=-2), torch.cat(ws, dim=-1)


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
    if d < 1:
        raise ValueError(f"the kernels take d >= 1, got d={d}")


def _launch(library: str, symbol: str, header: str, argtypes, *args) -> None:
    fn = getattr(_build.load(library, header=header), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {err}")


_P = ctypes.c_void_p
_I = ctypes.c_int


def _scratch(library: str, symbol: str, header: str, device, *shape_args: int) -> torch.Tensor:
    """The scratch a kernel's launch takes, sized by its library's
    ``<symbol>_scratch`` function of the same shapes."""
    fn = getattr(_build.load(library, header=header), symbol + "_scratch")
    fn.argtypes = [_I] * len(shape_args)
    fn.restype = ctypes.c_longlong
    nbytes = fn(*shape_args)
    if nbytes < 0:
        raise ValueError(f"{symbol} does not take the shapes {shape_args}")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _in_groups(launch, tensors, columns=(), max_batch=MAX_GRID_BATCH, max_columns=None):
    """``launch(*tensors)`` over groups of at most ``max_batch`` along dim 0
    of every tensor and, with ``max_columns``, over chunks of at most that
    many columns (the last dim) of the tensors at the positions ``columns``:
    full chunks first, the remainder last (t = 201 runs as 128 + 73).  The
    outputs (a tensor or a tuple of them) are summed over column chunks and
    concatenated over batch groups.  A batch and a width inside the limits
    make one call on the tensors as given."""
    nb = tensors[0].shape[0]
    t = tensors[columns[0]].shape[-1] if columns else 1
    width = t if max_columns is None else max_columns
    groups = []
    for b0 in range(0, nb, max_batch):
        group = [a[b0 : b0 + max_batch] for a in tensors]
        total = None
        for c0 in range(0, max(t, 1), max(width, 1)):
            args = list(group)
            if width < t:
                for k in columns:
                    args[k] = args[k][..., c0 : c0 + width].contiguous()
            out = launch(*args)
            out = out if isinstance(out, tuple) else (out,)
            total = out if total is None else tuple(a + b for a, b in zip(total, out))
        groups.append(total)
    outs = groups[0] if len(groups) == 1 else tuple(torch.cat(parts, dim=0) for parts in zip(*groups))
    return outs if len(outs) > 1 else outs[0]


def kernel_matvec(x1, x2, v, covar: str = "rbf") -> torch.Tensor:
    """K1: y = k(|x1_i - x2_j|^2) @ v, never storing the kernel matrix.

    x1 (*b, n, d), x2 (*b, m, d), v (*b, m, t) -> (*b, n, t), with at most
    one batch dim, a grid dimension of the kernel (launched in groups of at
    most MAX_GRID_BATCH).  Differentiable in x1, x2 and v."""
    return _KernelMatvec.apply(x1, x2, v, covar)


def rbf_matvec(x1, x2, v) -> torch.Tensor:
    """RBF alias of :func:`kernel_matvec` (K1)."""
    return kernel_matvec(x1, x2, v, "rbf")


def _kernel_matvec(x1, x2, v, covar):
    if not _on_cuda(x1, x2, v):
        return kernel_matvec_plain(x1, x2, v, covar)
    spec = _card_spec(covar)
    batched, (a, b, w) = _as_batched(x1, x2, v)
    nb, n, d = a.shape
    m = w.shape[-2]
    if b.shape != (nb, m, d) or w.shape[0] != nb:
        raise ValueError(f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, v {tuple(v.shape)}")
    _check_kernel_inputs((a, b, w), d)
    out = _in_groups(lambda a, b, w: _launch_matvec(a, b, w, spec), [a, b, w])
    return out if batched else out[0]


def _launch_matvec(a, b, w, spec):
    """One launch of K1 on (batch, n, d), (batch, m, d), (batch, m, t)."""
    nb, n, d = a.shape
    m, t = w.shape[-2:]
    tp = _k1_columns(t)
    # the kernel writes one partial result per split of K1_SPLIT x2 points
    partial = torch.empty((_cdiv(m, K1_SPLIT), nb, n, t), dtype=torch.float32, device=a.device)
    # x2 padded and v split into bf16 words by the launch's prepass
    scratch = _scratch("kernel_matvec", "kernel_matvec_f32", spec.header, a.device, nb, m, d, t, tp)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _launch(
        "kernel_matvec", "kernel_matvec_f32", spec.header,
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        a.data_ptr(), b.data_ptr(), w.data_ptr(), partial.data_ptr(), scratch.data_ptr(),
        nb, n, m, d, t, tp, spec.covar_id, spec.alpha, stream,
    )
    _count_launch(kernel_matvec, spec)
    return partial[0] if partial.shape[0] == 1 else partial.sum(dim=0)


# Columns per K1 CTA (8 NB in csrc/kernel_matvec.cu): its accumulators sit in
# registers, so a rhs wider than 72 columns runs as several column chunks.
K1_COLUMNS = (8, 16, 24, 32, 48, 72)


def _k1_columns(t: int) -> int:
    """K1's columns per CTA for a t-column v: as few chunks as possible (at
    most 72 columns each), each as narrow as K1_COLUMNS allows (t = 11 runs
    as one chunk of 16, t = 65 as one of 72, t = 73 as two of 48)."""
    need = _cdiv(t, _cdiv(t, K1_COLUMNS[-1]))
    return next(c for c in K1_COLUMNS if c >= need)


class _KernelMatvec(torch.autograd.Function):
    """K1 with the JAX package's ``_kernel_matvec_bwd``: dv = K^T g is K1 with
    x1 and x2 swapped, dx1 and dx2 take one K2 launch each."""

    @staticmethod
    def forward(ctx, x1, x2, v, covar):
        ctx.covar = covar
        ctx.save_for_backward(x1, x2, v)
        return _kernel_matvec(x1, x2, v, covar)

    @staticmethod
    def backward(ctx, g):
        x1, x2, v = ctx.saved_tensors
        g = g.contiguous()
        need_x1, need_x2, need_v, _ = ctx.needs_input_grad
        dx1 = _weighted_dx(x1, x2, g, v, ctx.covar) if need_x1 else None
        # W^T @ x1 and colsum(W): K2 with the roles of (x1, g) and (x2, v) swapped
        dx2 = _weighted_dx(x2, x1, v, g, ctx.covar) if need_x2 else None
        dv = _kernel_matvec(x2, x1, g, ctx.covar) if need_v else None
        return dx1, dx2, dv, None


def _weighted_dx(x1, x2, g, v, covar):
    """d/dx1 of sum(g * (k(x1, x2) @ v)) = 2 (rowsum(W) x1 - W @ x2)."""
    wx, ws = kernel_weighted(x1, x2, g, v, covar)
    return 2.0 * (ws[..., None] * x1 - wx)


def sym_matvec_supported(t: int) -> bool:
    """The port's gate for K3: rhs of 1..SYM_MAX_COLUMNS columns."""
    return 1 <= t <= SYM_MAX_COLUMNS


def kernel_matvec_sym(x, v, covar: str = "rbf") -> torch.Tensor:
    """K3: y = k(|x_i - x_j|^2) @ v for the symmetric kernel matrix, forming
    each off-diagonal tile once.

    x (*b, n, d), v (*b, n, t) -> (*b, n, t), at most one batch dim;
    ``sym_matvec_supported(t)`` must hold.  Differentiable in x and v."""
    return _KernelMatvecSym.apply(x, v, covar)


def rbf_matvec_sym(x, v) -> torch.Tensor:
    """RBF alias of :func:`kernel_matvec_sym` (K3)."""
    return kernel_matvec_sym(x, v, "rbf")


def _kernel_matvec_sym(x, v, covar):
    if not sym_matvec_supported(v.shape[-1]):
        raise ValueError(f"K3 takes 1..{SYM_MAX_COLUMNS} rhs columns, got {v.shape[-1]}")
    if not _on_cuda(x, v):
        return kernel_matvec_plain(x, x, v, covar)
    spec = _card_spec(covar)
    batched, (a, w) = _as_batched(x, v)
    nb, n, d = a.shape
    if w.shape[:2] != (nb, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, v {tuple(v.shape)}")
    _check_kernel_inputs((a, w), d)
    out = _in_groups(lambda a, w: _launch_matvec_sym(a, w, spec), [a, w])
    return out if batched else out[0]


def _launch_matvec_sym(a, w, spec):
    """One launch of K3 on (batch, n, d), (batch, n, t)."""
    nb, n, d = a.shape
    t = w.shape[-1]
    # rows of n rounded up to 4 floats, for the kernel's 16-byte atomics
    out_t = torch.zeros((nb, t, 4 * _cdiv(n, 4)), dtype=torch.float32, device=a.device)
    # x padded and v split into bf16 words by the launch's prepass
    scratch = _scratch("kernel_matvec_sym", "kernel_matvec_sym_f32", spec.header, a.device, nb, n, d, t)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _launch(
        "kernel_matvec_sym", "kernel_matvec_sym_f32", spec.header,
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        a.data_ptr(), w.data_ptr(), out_t.data_ptr(), scratch.data_ptr(),
        nb, n, d, t, spec.covar_id, spec.alpha, stream,
    )
    _count_launch(kernel_matvec_sym, spec)
    return out_t[..., :n].mT



class _KernelMatvecSym(torch.autograd.Function):
    """K3 with the JAX package's ``_kernel_matvec_sym_bwd``: x is both
    arguments of k(x, x), so dx sums the two K2 partials; dv = K g is K3 again,
    launched only when v needs a gradient (in the GP training step v holds
    constant solves, so its backward makes two K2 launches and no K3)."""

    @staticmethod
    def forward(ctx, x, v, covar):
        ctx.covar = covar
        ctx.save_for_backward(x, v)
        return _kernel_matvec_sym(x, v, covar)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_v, _ = ctx.needs_input_grad
        dx = None
        if need_x:
            dx = _weighted_dx(x, x, g, v, ctx.covar) + _weighted_dx(x, x, v, g, ctx.covar)
        dv = _kernel_matvec_sym(x, g, ctx.covar) if need_v else None
        return dx, dv, None


# Columns of g and v that one launch of K2 takes (its k-steps of 16 sit in
# registers); a wider g and v run in column chunks of this width
WEIGHTED_MAX_COLUMNS = 128


def kernel_weighted(x1, x2, g, v, covar: str = "rbf"):
    """K2: (W @ x2, rowsum(W)) with W_ij = k'(|x1_i - x2_j|^2) (g_i . v_j),
    never storing W.

    x1 (*b, n, d), x2 (*b, m, d), g (*b, n, t), v (*b, m, t) -> (*b, n, d),
    (*b, n), with at most one batch dim.  On the card, t above 128 runs as
    one launch per chunk of at most 128 columns, whose sums add: W is linear
    in g v^T = sum_c g_c v_c^T.  The callers assemble 2 (rowsum(W) x1 -
    W @ x2), the x1-gradient of sum(g * (k(x1, x2) @ v)).  g v^T runs as the
    TPU kernel's ``_dot_acc3`` (:func:`kernel_weighted_acc3_plain` repeats
    that arithmetic)."""
    if not _on_cuda(x1, x2, g, v):
        return kernel_weighted_plain(x1, x2, g, v, covar)
    spec = _card_spec(covar)
    batched, (a, b, gg, w) = _as_batched(x1, x2, g, v)
    nb, n, d = a.shape
    m, t = w.shape[-2:]
    if b.shape != (nb, m, d) or gg.shape != (nb, n, t) or w.shape[0] != nb:
        raise ValueError(
            f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, "
            f"g {tuple(g.shape)}, v {tuple(v.shape)}"
        )
    _check_kernel_inputs((a, b, gg, w), d)
    wx, ws = _in_groups(
        lambda a, b, gg, w: _launch_weighted(a, b, gg, w, spec), [a, b, gg, w],
        columns=(2, 3), max_columns=WEIGHTED_MAX_COLUMNS,
    )
    return (wx, ws) if batched else (wx[0], ws[0])


def _launch_weighted(a, b, gg, w, spec):
    """One launch of K2 on (batch, n, d), (batch, m, d), (batch, n, t),
    (batch, m, t), t <= WEIGHTED_MAX_COLUMNS."""
    nb, n, d = a.shape
    m, t = w.shape[-2:]
    # one partial result per split of K1_SPLIT x2 points
    parts = _cdiv(m, K1_SPLIT)
    wx = torch.empty((parts, nb, n, d), dtype=torch.float32, device=a.device)
    ws = torch.empty((parts, nb, n), dtype=torch.float32, device=a.device)
    # x2 padded and v split into bf16 words by the launch's prepass
    scratch = _scratch("kernel_weighted", "kernel_weighted_f32", spec.header, a.device, nb, m, d, t)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _launch(
        "kernel_weighted", "kernel_weighted_f32", spec.header,
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        a.data_ptr(), b.data_ptr(), gg.data_ptr(), w.data_ptr(), wx.data_ptr(), ws.data_ptr(), scratch.data_ptr(),
        nb, n, m, d, t, spec.covar_id, spec.alpha, stream,
    )
    _count_launch(kernel_weighted, spec)
    return (wx[0], ws[0]) if parts == 1 else (wx.sum(dim=0), ws.sum(dim=0))



# ---------------------------------------------------------------------------
# The bf16 upper-triangle tile cache (K4 builds it, K5 streams it)
# ---------------------------------------------------------------------------
#
# An iterative solve applies the same K some 20-300 times.  At n = 1e5 the
# f32 matrix (40 GB) does not fit beside the solver, but its upper triangle in
# bf16 does (9.47 GiB at tile 1024): K4 forms it once per solve, and every
# mat-vec after that streams it (K5) instead of forming K again.  The cached
# operator is exactly bf16(K), a fixed symmetric perturbation of K; v enters in
# a hi and a lo bf16 part (passes=2), so the product is exact in v to ~2^-17.

CACHE_TILE_EDGE = 128  # K4 and K5 take tiles that are multiples of this
# f32 entries the plain versions form at a time (512 MiB), so that at n = 1e5
# they hold a few GiB beside the 9.47 GiB cache
_PLAIN_CHUNK_ENTRIES = 2**27


def _triangle_maps(nblk: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j) of each upper-triangle tile pair, row-major (i outer, j >= i
    ascending), as int32: the JAX package's ``_triangle_maps`` order."""
    ij = torch.triu_indices(nblk, nblk, device=device).to(torch.int32)
    return ij[0].contiguous(), ij[1].contiguous()


def _check_tile(tile: int) -> None:
    if tile < CACHE_TILE_EDGE or tile % CACHE_TILE_EDGE:
        raise ValueError(f"the tile cache takes tiles that are positive multiples of {CACHE_TILE_EDGE}, got {tile}")


def rbf_build_sym_tiles_plain(x, tile: int = 1024, covar: str = "rbf") -> torch.Tensor:
    """Plain version of K4: bf16 k(sq_dist) on the upper-triangle tile pairs
    of x zero-padded to whole tiles, (npairs, tile, tile), formed a chunk of
    tile pairs at a time."""
    n, d = x.shape
    nblk = _cdiv(n, tile)
    xp = torch.zeros((nblk, tile, d), dtype=x.dtype, device=x.device)
    xp.view(-1, d)[:n] = x
    im, jm = (m.long() for m in _triangle_maps(nblk, x.device))
    fn = TILE_COVARS[covar].fn
    out = torch.empty((len(im), tile, tile), dtype=torch.bfloat16, device=x.device)
    step = max(1, _PLAIN_CHUNK_ENTRIES // (tile * tile))
    for s in range(0, len(im), step):
        sl = slice(s, s + step)
        out[sl] = fn(sq_dist(xp[im[sl]], xp[jm[sl]])).to(torch.bfloat16)
    return out


def _split_bf16(v: torch.Tensor, passes: int) -> list[torch.Tensor]:
    """v as f32 values of its bf16 parts: [bf16(v)] or [hi, lo] with
    hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return [hi] if passes == 1 else [hi, (v - hi).to(torch.bfloat16).float()]


def rbf_matvec_sym_cached_plain(tiles, v, n: int, tile: int = 1024, passes: int = 2) -> torch.Tensor:
    """Plain version of K5: y = bf16(K) v from K4's tiles, v (n, t) f32.
    Tile (i, j) adds K_ij v_j to block i and, for j > i, K_ij^T v_i to block
    j; each bf16 part of v is one f32 product, and the parts add.  Tiles are
    widened to f32 a chunk of tile pairs at a time."""
    t = v.shape[-1]
    nblk = _cdiv(n, tile)
    vp = torch.zeros((nblk * tile, t), dtype=torch.float32, device=v.device)
    vp[:n] = v
    parts = [p.view(nblk, tile, t) for p in _split_bf16(vp, passes)]
    im, jm = (m.long() for m in _triangle_maps(nblk, v.device))
    out = torch.zeros((nblk, tile, t), dtype=torch.float32, device=v.device)
    step = max(1, _PLAIN_CHUNK_ENTRIES // (tile * tile))
    with highest_matmul_precision():
        for s in range(0, len(im), step):
            sl = slice(s, s + step)
            k = tiles[sl].float()
            i, j = im[sl], jm[sl]
            off = j > i
            for p in parts:
                out.index_add_(0, i, torch.bmm(k, p[j]))
                out.index_add_(0, j[off], torch.bmm(k[off].mT, p[i[off]]))
    return out.view(-1, t)[:n]


def rbf_build_sym_tiles(x, tile: int = 1024, covar: str = "rbf") -> torch.Tensor:
    """K4: the bf16 upper-triangle tiles of k(|x_i - x_j|^2), (npairs, tile,
    tile) with npairs = nblk (nblk + 1) / 2 and nblk = ceil(n / tile), in
    the row-major triangle order of ``_triangle_maps``.

    x (n, d) f32, pre-scaled by the lengthscale, is zero-padded to whole
    tiles: the padded points give nonzero entries, which K5 multiplies by the
    zero padding of v."""
    _check_tile(tile)
    if not _on_cuda(x):
        return rbf_build_sym_tiles_plain(x, tile, covar)
    spec = _card_spec(covar)
    if x.ndim != 2:
        raise ValueError(f"K4 takes x of shape (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    _check_kernel_inputs((x,), d)
    nblk = _cdiv(n, tile)
    out = torch.empty((nblk * (nblk + 1) // 2, tile, tile), dtype=torch.bfloat16, device=x.device)
    # x padded to whole tiles (and its squared norms) by the launch's prepass
    scratch = _scratch("kernel_build_sym", "kernel_build_sym_tiles", spec.header, x.device, n, d, tile)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launch(
        "kernel_build_sym", "kernel_build_sym_tiles", spec.header,
        [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, d, tile, spec.covar_id, spec.alpha, stream,
    )
    _count_launch(rbf_build_sym_tiles, spec)
    return out



def rbf_matvec_sym_cached(tiles, v, n: int, tile: int = 1024, passes: int = 2) -> torch.Tensor:
    """K5: y = bf16(K) v from the tiles of :func:`rbf_build_sym_tiles`.

    v (n, t) f32 with 1 <= t <= SYM_MAX_COLUMNS -> (n, t) f32.  ``passes``
    2 multiplies by the hi and lo bf16 parts of v (exact in v to ~2^-17), 1
    by bf16(v) alone."""
    _check_tile(tile)
    if passes not in (1, 2):
        raise ValueError(f"passes is 1 or 2, got {passes}")
    nblk = _cdiv(n, tile)
    npairs = nblk * (nblk + 1) // 2
    if tuple(tiles.shape) != (npairs, tile, tile) or v.ndim != 2 or v.shape[0] != n:
        raise ValueError(
            f"shape mismatch: tiles {tuple(tiles.shape)}, v {tuple(v.shape)} for n={n}, tile={tile} "
            f"({npairs} tile pairs)"
        )
    t = v.shape[1]
    if not sym_matvec_supported(t):
        raise ValueError(f"K5 takes 1..{SYM_MAX_COLUMNS} rhs columns, got {t}")
    if not _on_cuda(tiles, v):
        return rbf_matvec_sym_cached_plain(tiles, v, n, tile, passes)
    if tiles.dtype != torch.bfloat16:
        raise TypeError(f"K5 takes bfloat16 tiles, got {tiles.dtype}")
    if v.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {v.dtype}")
    if not (tiles.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")
    # rows of n rounded up to 4 floats, for the kernel's 16-byte atomics
    out_t = torch.zeros((t, 4 * _cdiv(n, 4)), dtype=torch.float32, device=v.device)
    # v split into bf16 words by the launch's prepass
    scratch = _scratch("kernel_matvec_cached", "kernel_matvec_sym_cached", "", v.device, n, t)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _launch(
        "kernel_matvec_cached", "kernel_matvec_sym_cached", "",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        tiles.data_ptr(), v.data_ptr(), out_t.data_ptr(), scratch.data_ptr(), n, t, tile, npairs, passes, stream,
    )
    rbf_matvec_sym_cached.launches += 1
    return out_t[:, :n].mT


reset_launch_counts()
