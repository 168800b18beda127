"""Symmetric Toeplitz operator with an O(N log N) FFT mat-vec (counterpart of
linear_operator_tpu/operators/toeplitz.py).

The mat-vec takes the FFT route (circulant embedding, ``torch.fft``) when
``settings.use_toeplitz`` is on and n >= ``settings.toeplitz_fft_min_size``,
and the dense route (one full-f32 product with the gathered matrix) below it.
Both are PyTorch operations, so autograd differentiates the mat-vec: the
gradient reaching ``column`` is the derivative quadratic form.
"""

from __future__ import annotations

import torch

from .. import settings
from ..utils.cholesky import highest_matmul_precision
from ._linear_operator import LinearOperator


def toeplitz_matmul(column: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Symmetric-Toeplitz mat-mat by circulant embedding: column (*b, n),
    rhs (*b, n, t).  T sits in the 2n-circulant with first column
    ``[c_0..c_{n-1}, 0, c_{n-1}..c_1]``; the product is taken in Fourier
    space."""
    n = column.shape[-1]
    zero = torch.zeros((*column.shape[:-1], 1), dtype=column.dtype, device=column.device)
    circ = torch.cat([column, zero, torch.flip(column[..., 1:], dims=(-1,))], dim=-1)
    f_circ = torch.fft.rfft(circ, dim=-1)  # (*b, n + 1)
    x = torch.nn.functional.pad(rhs, (0, 0, 0, n))  # (*b, 2n, t)
    f_x = torch.fft.rfft(x, dim=-2)
    out = torch.fft.irfft(f_x * f_circ[..., :, None], n=2 * n, dim=-2)
    return out[..., :n, :].to(rhs.dtype)


class ToeplitzLinearOperator(LinearOperator):
    def __init__(self, column: torch.Tensor):
        self.column = column  # (*b, n) first column of a symmetric Toeplitz matrix

    def _shape(self) -> tuple[int, ...]:
        return (*self.column.shape, self.column.shape[-1])

    def _uses_fft(self) -> bool:
        return settings.use_toeplitz.on() and self.column.shape[-1] >= settings.toeplitz_fft_min_size.value()

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        if self._uses_fft():
            return toeplitz_matmul(self.column, rhs)
        # the dense route in full f32 (no TF32): this mat-vec feeds CG, as the
        # JAX package's Precision.HIGH product does
        with highest_matmul_precision():
            return torch.matmul(self.to_dense(), rhs)

    def _t_matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        return self._matmul(rhs)

    def _transpose(self) -> "ToeplitzLinearOperator":
        return self

    def _diagonal(self) -> torch.Tensor:
        n = self.column.shape[-1]
        return self.column[..., :1].expand(*self.column.shape[:-1], n)

    def to_dense(self) -> torch.Tensor:
        n = self.column.shape[-1]
        i = torch.arange(n, device=self.column.device)
        return self.column[..., (i[:, None] - i[None, :]).abs()]

    def _get_indices(self, row_index, col_index, *batch_indices) -> torch.Tensor:
        return self.column[(*batch_indices, (row_index - col_index).abs())]

    def _getitem(self, row_index, col_index, *batch_indices) -> LinearOperator:
        if (
            isinstance(row_index, slice)
            and isinstance(col_index, slice)
            and row_index == col_index
            and row_index.step in (None, 1)
        ):
            start, stop, _ = row_index.indices(self.column.shape[-1])
            # a principal contiguous block of a Toeplitz matrix is Toeplitz
            return ToeplitzLinearOperator(self.column[(*batch_indices, slice(0, stop - start))])
        return super()._getitem(row_index, col_index, *batch_indices)

    def _expand_batch(self, batch_shape) -> "ToeplitzLinearOperator":
        return ToeplitzLinearOperator(self.column.expand(*batch_shape, self.column.shape[-1]))
