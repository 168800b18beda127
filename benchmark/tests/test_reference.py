"""The plain references against the port at tiny sizes on the CPU, in float64
(the port's plain path: no fused kernels, no dense cache), on the same
inputs and the same generator states.  The comparison lives here; the
references know nothing of the port."""

import math

import pytest
import torch

import linear_operator_tpu_torch as lo
from benchmark import harness
from benchmark.reference import exact_gp as ref_gp
from benchmark.reference import love as ref_love

F64 = torch.float64
# few enough CG iterations that two float64 implementations of CG follow
# one trajectory (past ~15 unconverged iterations their rounding diverges)
SHORT = dict(harness.read_json("configs", "exact-rbf-n100k")["settings"], max_cg_iterations=12,
             max_lanczos_quadrature_iterations=8, max_root_decomposition_size=40)


def _data(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    x, y = harness.regression_data(torch, n, 3, 0.1, g, "cpu")
    return x.to(F64), y.to(F64), g


def _model(raw_noise=-2.0):
    m = lo.ExactGPRegression(device="cpu", dtype=F64, use_fused_kernels=False, materialize_threshold=None)
    with torch.no_grad():
        m.raw_noise.fill_(raw_noise)
    return m


def test_bbmm_step_matches_the_port():
    x, y, g = _data(2500)
    state = g.get_state()
    m = _model()
    with harness.apply_settings(lo, SHORT):
        loss = m.neg_mll(x, y, generator=g)
    loss.backward()
    g2 = torch.Generator()
    g2.set_state(state)
    ref_loss, ref_grad, iterations = ref_gp.loss_and_grad(x, y, torch.tensor([0.0, 0.0, -2.0], dtype=F64), SHORT, g2,
                                                    draw_dtype=F64)
    assert iterations == 12
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-8)
    port_grad = torch.stack([m.raw_lengthscale.grad, m.raw_outputscale.grad, m.raw_noise.grad])
    assert torch.allclose(port_grad, ref_grad, rtol=1e-7, atol=1e-10)


def test_love_cache_and_answers_match_the_port():
    x, y, g = _data(2500)
    state = g.get_state()
    m = _model()
    x_star = torch.randn(64, 3, dtype=F64, generator=torch.Generator().manual_seed(9))
    with harness.apply_settings(lo, SHORT), torch.no_grad():
        cache = m.posterior_cache(x, y, generator=g)
        mean, var = m.posterior_from_cache(x, cache, x_star)
    ls, os, s2 = (float(v) for v in ref_gp.softplus(torch.tensor([0.0, 0.0, -2.0], dtype=F64)))
    g2 = torch.Generator()
    g2.set_state(state)
    alpha, root = ref_love.cache(x, y, ls, os, s2, SHORT, g2, draw_dtype=F64)
    assert torch.allclose(alpha, cache.alpha[:, 0], rtol=1e-8, atol=1e-10)
    ref_mean, ref_var = ref_love.predict(x, alpha, root, x_star, ls, os)
    assert torch.allclose(mean, ref_mean, rtol=1e-8, atol=1e-10)
    assert torch.allclose(var, ref_var, rtol=1e-6, atol=1e-9)
    assert math.isclose(float((root @ root.mT - cache.root_inv @ cache.root_inv.mT).abs().max()), 0.0, abs_tol=1e-6)
