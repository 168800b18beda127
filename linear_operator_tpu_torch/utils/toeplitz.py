"""Toeplitz function family: construction, indexing, FFT matmul, derivative
(counterpart of linear_operator_tpu/utils/toeplitz.py).

Construction is one gather (``column[|i - j|]``); the circulant-embedding
matmul multiplies in Fourier space with ``torch.fft.rfft``/``irfft`` of
length 2n - 1 for real data (``fft``/``ifft`` when either operand is
complex); the derivative quadratic form is the vector-Jacobian product of the
linear map ``c -> T(c) @ v``, taken by autograd through that matmul.

The symmetric ``ToeplitzLinearOperator`` lives in ``operators/toeplitz.py``.
"""

from __future__ import annotations

import torch


def toeplitz(toeplitz_column: torch.Tensor, toeplitz_row: torch.Tensor) -> torch.Tensor:
    """Dense Toeplitz matrix from its first column and first row:
    ``T[i, j] = column[i - j]`` for i >= j, else ``row[j - i]``;
    ``column[..., 0]`` must equal ``row[..., 0]`` (not checked)."""
    if toeplitz_column.shape != toeplitz_row.shape:
        raise ValueError(
            "column and row must have the same shape (Toeplitz matrices are "
            f"necessarily square); got {tuple(toeplitz_column.shape)} vs {tuple(toeplitz_row.shape)}"
        )
    n = toeplitz_column.shape[-1]
    i = torch.arange(n, device=toeplitz_column.device)
    delta = i[:, None] - i[None, :]  # (n, n), > 0 below the diagonal
    dist = delta.abs()
    return torch.where(delta >= 0, toeplitz_column[..., dist], toeplitz_row[..., dist])


def sym_toeplitz(toeplitz_column: torch.Tensor) -> torch.Tensor:
    """Dense symmetric Toeplitz matrix."""
    return toeplitz(toeplitz_column, toeplitz_column)


def toeplitz_getitem(toeplitz_column, toeplitz_row, i, j) -> torch.Tensor:
    """``T[i, j]`` of the Toeplitz matrix defined by (column, row); i and j
    may be index tensors."""
    delta = torch.as_tensor(i) - torch.as_tensor(j)
    dist = delta.abs()
    return torch.where(delta >= 0, toeplitz_column[..., dist], toeplitz_row[..., dist])


def sym_toeplitz_getitem(toeplitz_column, i, j) -> torch.Tensor:
    """``T[i, j]`` of the symmetric Toeplitz matrix."""
    return toeplitz_getitem(toeplitz_column, toeplitz_column, i, j)


def toeplitz_matmul(toeplitz_column: torch.Tensor, toeplitz_row: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    """``T @ tensor`` in O(n log n) by circulant embedding: T sits in the
    (2n - 1)-circulant with first column ``[c_0..c_{n-1}, r_{n-1}..r_1]``.

    column/row: (*b, n); tensor: (*b, n, t) or (n,).  Batch dims broadcast."""
    if toeplitz_column.shape != toeplitz_row.shape:
        raise ValueError(
            "column and row must have the same shape; got "
            f"{tuple(toeplitz_column.shape)} vs {tuple(toeplitz_row.shape)}"
        )
    is_vector = tensor.ndim == 1
    if is_vector:
        tensor = tensor[:, None]
    n = toeplitz_column.shape[-1]
    m = 2 * n - 1
    c_r_rev = torch.cat([toeplitz_column, torch.flip(toeplitz_row[..., 1:], dims=(-1,))], dim=-1)  # (*b, 2n-1)
    x = torch.nn.functional.pad(tensor, (0, 0, 0, n - 1))  # (*b, 2n-1, t)
    if tensor.is_complex() or toeplitz_column.is_complex():
        # a complex operand makes T @ x genuinely complex: keep it
        out = torch.fft.ifft(torch.fft.fft(x, dim=-2) * torch.fft.fft(c_r_rev, dim=-1)[..., :, None], dim=-2)
    else:
        f_x = torch.fft.rfft(x, dim=-2)
        f_c = torch.fft.rfft(c_r_rev, dim=-1)[..., :, None]
        out = torch.fft.irfft(f_x * f_c, n=m, dim=-2)
        out = out.to(torch.promote_types(tensor.dtype, toeplitz_column.dtype))
    out = out[..., :n, :]
    return out[..., 0] if is_vector else out


def sym_toeplitz_matmul(toeplitz_column: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    """``T @ tensor`` for symmetric Toeplitz T."""
    return toeplitz_matmul(toeplitz_column, toeplitz_column, tensor)


def sym_toeplitz_derivative_quadratic_form(left_vectors: torch.Tensor, right_vectors: torch.Tensor) -> torch.Tensor:
    r"""``res[i] = sum_j u[j]^T (dT/dc_i) v[j]`` for symmetric Toeplitz T: the
    gradient of ``sum_j u[j]^T T(c) v[j]`` with respect to the first column
    c.  T(c) is linear in c, so this is the (constant) vector-Jacobian
    product of ``c -> T(c) @ V`` with cotangent U.

    left_vectors/right_vectors: (*b, m) single vectors or (*b, m, s) stacks
    (vectors in columns).  Returns (*b, m)."""
    if left_vectors.ndim == 1:
        left_vectors = left_vectors[:, None]
        right_vectors = right_vectors[:, None]
    m = left_vectors.shape[-2]
    c0 = torch.zeros(
        (*left_vectors.shape[:-2], m), dtype=left_vectors.dtype, device=left_vectors.device, requires_grad=True
    )
    with torch.enable_grad():
        out = sym_toeplitz_matmul(c0, right_vectors.detach())
        (grad_c,) = torch.autograd.grad(out, c0, grad_outputs=left_vectors.detach())
    return grad_c
