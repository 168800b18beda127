"""Multivariate normal over a lazy covariance operator (counterpart of
linear_operator_tpu/distributions.py).

Every density computation routes through the operator's structure-aware
methods: ``log_prob`` is one ``inv_quad_logdet`` (CG + SLQ above the
Cholesky cutoff), ``rsample`` the operator's ``zero_mean_mvn_samples``
(structured roots, Lanczos, or contour integral quadrature under
``settings.ciq_samples``), the KL divergence solves against a root of the
first covariance.  Where the JAX class takes ``key=``, this one takes a
``torch.Generator`` as ``generator=`` (a fixed one when None).
"""

from __future__ import annotations

import math

import torch

from .operators import DenseLinearOperator, LinearOperator, TriangularLinearOperator

_LOG_2PI = math.log(2.0 * math.pi)

# root columns per block of the lazy KL trace term
_KL_LAZY_BLOCK = 256


class MultivariateNormal:
    """N(mean, K): ``mean`` (*b, n), ``lazy_covariance_matrix`` a (*b, n, n)
    operator (a tensor is wrapped in a DenseLinearOperator)."""

    def __init__(self, mean: torch.Tensor, lazy_covariance_matrix):
        if not isinstance(lazy_covariance_matrix, LinearOperator):
            lazy_covariance_matrix = DenseLinearOperator(torch.as_tensor(lazy_covariance_matrix))
        self.mean = mean
        self.lazy_covariance_matrix = lazy_covariance_matrix

    # -- shapes --------------------------------------------------------
    @property
    def event_shape(self) -> tuple[int, ...]:
        return (self.mean.shape[-1],)

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(torch.broadcast_shapes(self.mean.shape[:-1], self.lazy_covariance_matrix.batch_shape))

    # -- moments -------------------------------------------------------
    @property
    def loc(self) -> torch.Tensor:
        return self.mean

    @property
    def covariance_matrix(self) -> torch.Tensor:
        dense = self.lazy_covariance_matrix.to_dense()
        # the mean may carry batch dims the covariance lacks
        return dense.expand(*self.batch_shape, *dense.shape[-2:])

    @property
    def variance(self) -> torch.Tensor:
        d = self.lazy_covariance_matrix.diagonal()
        return d.expand(*self.batch_shape, d.shape[-1])

    @property
    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.variance)

    def confidence_region(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean - 2 sd, mean + 2 sd)."""
        sd2 = 2.0 * self.stddev
        return self.mean - sd2, self.mean + sd2

    def add_jitter(self, jitter_val: float = 1e-3) -> "MultivariateNormal":
        return MultivariateNormal(self.mean, self.lazy_covariance_matrix.add_jitter(jitter_val))

    def expand(self, batch_shape) -> "MultivariateNormal":
        n = self.mean.shape[-1]
        mean = self.mean.expand(*batch_shape, n)
        return MultivariateNormal(mean, self.lazy_covariance_matrix._expand_batch(tuple(batch_shape)))

    # -- density -------------------------------------------------------
    def log_prob(self, value: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """Gaussian log density by one ``inv_quad_logdet``; ``value`` is
        (*s, *b, n), its leading sample dims folded into solve columns."""
        diff = value - self.mean
        n = diff.shape[-1]
        cov = self.lazy_covariance_matrix
        nb = len(self.batch_shape)
        sample_shape = diff.shape[: diff.ndim - 1 - nb]
        if sample_shape:
            s = math.prod(sample_shape)
            d = diff.reshape(s, *diff.shape[len(sample_shape) :]).movedim(0, -1)  # (*b, n, s)
            iq, ld = cov.inv_quad_logdet(d, logdet=True, reduce_inv_quad=False, generator=generator)
            iq = iq.movedim(-1, 0).reshape(*sample_shape, *self.batch_shape)
        else:
            iq, ld = cov.inv_quad_logdet(diff[..., None], logdet=True, generator=generator)
        return -0.5 * (iq + ld + n * _LOG_2PI)

    def entropy(self, *, generator: torch.Generator | None = None) -> torch.Tensor:
        n = self.mean.shape[-1]
        _, ld = self.lazy_covariance_matrix.inv_quad_logdet(None, logdet=True, generator=generator)
        return 0.5 * (n * (1.0 + _LOG_2PI) + ld)

    # -- sampling ------------------------------------------------------
    def rsample(self, sample_shape=(), *, generator: torch.Generator | None = None) -> torch.Tensor:
        """Reparameterized draws, (*sample_shape, *b, n): the mean plus the
        covariance's ``zero_mean_mvn_samples``."""
        sample_shape = tuple(sample_shape)
        num = math.prod(sample_shape) if sample_shape else 1
        z = self.lazy_covariance_matrix.zero_mean_mvn_samples(num, generator=generator)
        out = self.mean + z  # (num, *b, n)
        return out.reshape(*sample_shape, *out.shape[1:]) if sample_shape else out[0]

    def sample(self, sample_shape=(), *, generator: torch.Generator | None = None) -> torch.Tensor:
        with torch.no_grad():
            return self.rsample(sample_shape, generator=generator)

    # -- divergences ---------------------------------------------------
    def kl_divergence(self, other: "MultivariateNormal", *, generator: torch.Generator | None = None) -> torch.Tensor:
        """KL(self || other) by operator solves:

        0.5 [tr(S2^-1 S1) + (m2 - m1)^T S2^-1 (m2 - m1) - n + log|S2| - log|S1|]

        with tr(S2^-1 S1) = sum(R1 o S2^-1 R1) for any root S1 = R1 R1^T:
        exact for a structured root, Lanczos-approximate otherwise.  One
        generator serves the root's start vector and both SLQ estimates, each
        drawing its own numbers in turn."""
        n = self.mean.shape[-1]
        s1, s2 = self.lazy_covariance_matrix, other.lazy_covariance_matrix
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        root_op = s1.root_decomposition(generator=generator).root  # (*b, n, k) operator
        mdiff = (other.mean - self.mean)[..., None]
        k = root_op.shape[-1]
        if isinstance(root_op, (DenseLinearOperator, TriangularLinearOperator)) or k <= _KL_LAZY_BLOCK:
            # one solve over the stacked [root | mdiff] columns
            r1 = root_op.to_dense()
            joint = torch.broadcast_shapes(r1.shape[:-2], mdiff.shape[:-2])
            rhs = torch.cat([r1.expand(*joint, *r1.shape[-2:]), mdiff.expand(*joint, *mdiff.shape[-2:])], dim=-1)
            iq, ld2 = s2.inv_quad_logdet(rhs, logdet=True, reduce_inv_quad=False, generator=generator)
            trace_term = torch.sum(iq[..., :-1], dim=-1)
            maha = iq[..., -1]
        else:
            # a structured root with many columns: the trace term streams its
            # columns in blocks, never forming the (n, k) dense factor
            trace_term = _lazy_trace_term(s2, root_op, generator)
            iq, ld2 = s2.inv_quad_logdet(mdiff, logdet=True, reduce_inv_quad=False, generator=generator)
            maha = iq[..., 0]
            trace_term = trace_term.expand(torch.broadcast_shapes(trace_term.shape, maha.shape))
        _, ld1 = s1.inv_quad_logdet(None, logdet=True, generator=generator)
        return 0.5 * (trace_term + maha - n + ld2 - ld1)


def _lazy_trace_term(s2, root_op, generator) -> torch.Tensor:
    """tr(R1^T S2^{-1} R1) over column blocks of the lazy root: block i's
    columns are R1 E_i with E_i a (k, block) one-hot slab, through the root's
    own ``_matmul``; the last block's out-of-range columns are zero and add
    nothing."""
    k = root_op.shape[-1]
    batch = torch.broadcast_shapes(s2.batch_shape, root_op.batch_shape)
    acc = torch.zeros(batch, dtype=s2.dtype, device=s2.device)
    cols_idx = torch.arange(_KL_LAZY_BLOCK, device=s2.device)
    for start in range(0, k, _KL_LAZY_BLOCK):
        idx = start + cols_idx
        E = (torch.arange(k, device=s2.device)[:, None] == idx[None, :]).to(root_op.dtype)  # (k, block)
        cols = root_op._matmul(E)  # (*b, n, block)
        iq, _ = s2.inv_quad_logdet(cols, logdet=False, reduce_inv_quad=True, generator=generator)
        acc = acc + iq
    return acc


__all__ = ["MultivariateNormal"]
