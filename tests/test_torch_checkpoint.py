"""The checkpoint-resume contract of tests/test_checkpoint.py, for the port.

An exact GP (n = 64, d = 2, the JAX test's data shape) trained four Adam
steps straight is held against one trained two steps, saved with
``torch.save`` (the model's and Adam's ``state_dict`` and the probe
generator's ``get_state()``) to a temporary directory, reloaded into a fresh
model, optimizer and generator, and trained two more: the restored state is
bit-identical and the resumed losses match the straight run's at the JAX
test's rtol 1e-6 / atol 1e-7.  Once on the Cholesky route (the default
settings at n = 64) and once on CG + SLQ (``max_cholesky_size(0)``), where
every step draws its probes from the generator.
"""

import contextlib

import numpy as np
import pytest
import torch

import linear_operator_tpu_torch as lo
from linear_operator_tpu_torch import settings
from test_torch_harness_common import one_torch_thread  # noqa: F401 (an autouse fixture)

N, D, LR = 64, 2, 0.05


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=N)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _fresh():
    torch.manual_seed(0)
    model = lo.ExactGPRegression(device="cpu")
    return model, torch.optim.Adam(model.parameters(), lr=LR), torch.Generator().manual_seed(1)


def _steps(model, opt, gen, x, y, k):
    losses = []
    for _ in range(k):
        opt.zero_grad()
        loss = model.neg_mll(x, y, generator=gen)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses


def _same(a, b):
    """Bit-identical nested state (tensors, numbers, dicts, lists)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(p, q) for p, q in zip(a, b))
    return a == b


@pytest.mark.parametrize("route", ["cholesky", "cg"])
def test_train_checkpoint_resume(route, tmp_path):
    x, y = _data()
    scope = settings.max_cholesky_size(0) if route == "cg" else contextlib.nullcontext()
    with scope:
        straight = _steps(*_fresh(), x, y, 4)

        model, opt, gen = _fresh()
        _steps(model, opt, gen, x, y, 2)
        path = tmp_path / "ckpt.pt"
        torch.save(dict(model=model.state_dict(), opt=opt.state_dict(), gen=gen.get_state()), path)

        model2, opt2, gen2 = _fresh()
        saved = torch.load(path)
        model2.load_state_dict(saved["model"])
        opt2.load_state_dict(saved["opt"])
        gen2.set_state(saved["gen"])
        assert _same(model2.state_dict(), model.state_dict())
        assert _same(opt2.state_dict(), opt.state_dict())
        assert torch.equal(gen2.get_state(), gen.get_state())

        resumed = _steps(model2, opt2, gen2, x, y, 2)
    np.testing.assert_allclose(resumed, straight[2:], rtol=1e-6, atol=1e-7)
    assert all(np.isfinite(straight)) and straight[3] < straight[0]
