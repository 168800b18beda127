"""The RBF kernel k(a, b) = s exp(-|a - b|^2 / (2 l^2)) in plain PyTorch, in
blocks of rows so that no n x n matrix is held.

Each block is formed as exp(a.b - |b|^2 / 2) scaled by exp(-|a|^2 / 2) per
row (a, b the points over l): one product, one exponent and one product with
the vectors, in the inputs' dtype (float32 for the references of the
configurations here, whose stated precision is float32 with TF32 off; the
control runs the same code with TF32 products).
"""

from __future__ import annotations

import torch

BLOCK_ENTRIES = 2**28  # entries of one block of rows (2 GiB in float64)


def _blocks(n1: int, n2: int, block_entries: int):
    rows = max(1, block_entries // max(n2, 1))
    for i in range(0, n1, rows):
        yield i, min(i + rows, n1)


def _scaled(x1, x2, ls):
    a, b = x1 / ls, x2 / ls
    return a, b, -0.5 * (a * a).sum(-1), -0.5 * (b * b).sum(-1)


def _exponent(a, b, half_a2, half_b2):
    """(exp(a.b - |b|^2 / 2), exp(-|a|^2 / 2), a.b - |b|^2 / 2) for a block."""
    g = torch.addmm(half_b2[None, :], a, b.mT)
    return g.exp(), half_a2.exp(), g


def _block(a, b, half_a2, half_b2):
    """(exp(a.b - |b|^2 / 2), exp(-|a|^2 / 2)), the first formed in place."""
    return torch.addmm(half_b2[None, :], a, b.mT).exp_(), half_a2.exp()


def matmul(x1, x2, v, ls, os, block_entries: int = BLOCK_ENTRIES):
    """k(x1, x2) @ v, (n1, t)."""
    a, b, ha, hb = _scaled(x1, x2, ls)
    out = torch.empty(x1.shape[0], v.shape[-1], dtype=v.dtype, device=v.device)
    for i, j in _blocks(x1.shape[0], x2.shape[0], block_entries):
        e, u = _block(a[i:j], b, ha[i:j], hb)
        out[i:j] = (e @ v) * (os * u)[:, None]
    return out


def column(x, p: int, ls, os):
    """k(x, x_p), (n,)."""
    d2 = ((x - x[p]) / ls).square().sum(-1)
    return os * torch.exp(-0.5 * d2)


def bilinear(x, left, right, ls, os, block_entries: int = BLOCK_ENTRIES):
    """(sum_c left_c^T dK/dl right_c, sum_c left_c^T dK/ds right_c) for
    K = k(x, x): dK/ds = K / s and dK/dl = K o |a - b|^2 / l (a, b the
    points over l)."""
    a, b, ha, hb = _scaled(x, x, ls)
    d_ls = torch.zeros((), dtype=left.dtype, device=left.device)
    d_os = torch.zeros((), dtype=left.dtype, device=left.device)
    for i, j in _blocks(x.shape[0], x.shape[0], block_entries):
        e, u, g = _exponent(a[i:j], b, ha[i:j], hb)
        p1 = (e @ right) * u[:, None]  # (K / s) right on the rows
        p2 = ((e * g) @ right) * u[:, None]
        # |a - b|^2 = |a|^2 - 2 (a.b - |b|^2 / 2)
        sq = (-2.0 * ha[i:j])[:, None] * p1 - 2.0 * p2
        d_os = d_os + (left[i:j] * p1).sum()
        d_ls = d_ls + os / ls * (left[i:j] * sq).sum()
    return d_ls, d_os
