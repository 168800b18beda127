"""Base test case: seeded generators and allclose with diagnostics
(counterpart of linear_operator_tpu/test/base_test_case.py).

Each test draws from ``self.generator``, a fresh CPU ``torch.Generator`` per
call, seeded from the class's ``seed`` and a per-test counter, so a test
draws the same numbers in every run and on every device (``utils.random``
moves CPU draws to the case's ``device``).  ``UNLOCK_SEED=1`` picks a random
seed instead.
"""

from __future__ import annotations

import os
import unittest

import numpy as np
import torch

from ..utils.random import randn


class BaseTestCase(unittest.TestCase):
    seed = 0
    device = "cpu"

    def setUp(self):
        super().setUp()
        seed = self.seed
        if os.environ.get("UNLOCK_SEED", "").lower() in ("true", "1"):
            seed = int(np.random.randint(0, 2**31 - 1))
        self._seed = seed
        self._draws = 0

    @property
    def generator(self) -> torch.Generator:
        self._draws += 1
        return torch.Generator().manual_seed(self._seed * 1_000_003 + self._draws)

    def randn(self, *shape, dtype=torch.float64) -> torch.Tensor:
        """N(0, 1) of ``shape`` on the case's device, from ``generator``."""
        return randn(shape, dtype, self.device, self.generator)

    def tensor(self, array, dtype=None) -> torch.Tensor:
        """A numpy array (or nested list) as a tensor on the case's device;
        floating arrays take ``dtype`` (float64 by default)."""
        a = np.asarray(array)
        if a.dtype.kind == "f":
            return torch.tensor(a, dtype=dtype or torch.float64, device=self.device)
        return torch.tensor(a, device=self.device)

    def assertAllClose(self, actual, expected, rtol=1e-4, atol=1e-5, msg=None):
        """Elementwise closeness; NaN never matches, and a failure reports
        the largest violation."""

        def as_np(x):
            if isinstance(x, torch.Tensor):
                return x.detach().cpu().numpy()
            return np.asarray(x)

        actual, expected = as_np(actual), as_np(expected)
        self.assertEqual(actual.shape, expected.shape, msg or f"shape mismatch: {actual.shape} vs {expected.shape}")
        if np.allclose(actual, expected, rtol=rtol, atol=atol):
            return
        abs_diff = np.abs(actual - expected)
        bad = (abs_diff > atol + rtol * np.abs(expected)) | ~np.isfinite(abs_diff)
        raise AssertionError(
            f"{msg or 'assertAllClose failed'}: {bad.sum()}/{bad.size} elements violate "
            f"rtol={rtol}, atol={atol}. max abs diff {abs_diff.max():.3e} "
            f"(rtol would need {np.nanmax(abs_diff / np.maximum(np.abs(expected), 1e-30)):.3e}, "
            f"atol would need {abs_diff.max():.3e})"
        )
