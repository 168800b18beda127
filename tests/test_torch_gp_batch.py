"""The port's exact GP on a batch of independent GPs against the JAX package:
``neg_mll`` and ``posterior``, values and gradients, for x (2, n, d) with
y (2, n) and for one x (n, d) with y (2, n).  As in
``test_torch_gp_slice.py``, whose helpers these tests share: float64 on the
blocked path at rtol 1e-7, float32 on the fused path (the kernels' plain
versions here) at rtol 1e-4, gradients relative to their norm, the
preconditioner's probe draws identical in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gp_slice import (  # noqa: F401  (same_probes is a fixture)
    GRAD_CASES,
    SLICE,
    _Both,
    _close,
    _grad_close,
    _jax_grads,
    _models,
    _np,
    _port_grads,
    same_probes,
)
from test_torch_harness_common import _jit, one_torch_thread  # noqa: F401 (an autouse fixture)



def _batched_data(layout, dtype, n=96, m=12):
    """Two GPs, as x (2, n, d) with y (2, n) and x_star (2, m, d), or as one
    x (n, d) with y (2, n) and x_star (m, d)."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, n, 3) if layout == "x_and_y" else (n, 3))
    y = np.sin(3.0 * x[..., 0]) + 0.1 * rng.normal(size=x.shape[:-1])
    y = y if layout == "x_and_y" else np.stack([y, np.cos(2.0 * x[:, 1])])
    x_star = rng.normal(size=(*x.shape[:-2], m, 3))
    return (a.astype(dtype) for a in (x, y, x_star))


BATCH_CASES = [(layout, *case) for layout in ("x_and_y", "y_only") for case in GRAD_CASES]


@pytest.mark.parametrize("layout, fused, dtype, block_rows, rtol", BATCH_CASES)
def test_batched_neg_mll_and_grads_match_jax(same_probes, layout, fused, dtype, block_rows, rtol):
    """neg_mll of a batch of GPs and its gradient, against the JAX package on
    identical probes: f64 on the blocked path, f32 on the fused one."""
    same_probes(dtype)
    x, y, _ = _batched_data(layout, dtype)
    jmodel, params, tmodel = _models(fused, dtype, block_rows)
    with _Both(**SLICE):
        want, jg = _jit(jax.value_and_grad(
            lambda p: jmodel.neg_mll(p, jnp.asarray(x), jnp.asarray(y), key=jax.random.PRNGKey(0))
        ))(params)
        loss = tmodel.neg_mll(torch.from_numpy(x), torch.from_numpy(y), generator=torch.Generator())
        loss.backward()
    np.testing.assert_allclose(_np(loss), _np(want), rtol=rtol)
    _grad_close(_port_grads(tmodel), _jax_grads(jg), rtol)


@pytest.mark.parametrize("layout, fused, dtype, block_rows, rtol", BATCH_CASES)
def test_batched_posterior_and_grads_match_jax(layout, fused, dtype, block_rows, rtol):
    """The posterior of a batch of GPs, mean and variance (2, m), and the
    gradient of sum(mean) + sum(var), against the JAX package."""
    x, y, x_star = _batched_data(layout, dtype)
    jmodel, params, tmodel = _models(fused, dtype, block_rows)

    def jloss(p):
        mean, var = jmodel.posterior(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_star))
        return jnp.sum(mean) + jnp.sum(var), (mean, var)

    with _Both(**SLICE):
        jg, (jmean, jvar) = _jit(jax.grad(jloss, has_aux=True))(params)
        mean, var = tmodel.posterior(*(torch.from_numpy(a) for a in (x, y, x_star)))
        (mean.sum() + var.sum()).backward()
    assert mean.shape == var.shape == (2, 12)
    _close(mean, jmean, rtol)
    _close(var, jvar, rtol)
    _grad_close(_port_grads(tmodel), _jax_grads(jg), rtol)
