"""Shared test helpers (counterpart of linear_operator_tpu/test/utils.py)."""

from __future__ import annotations

import numpy as np
import torch


def approx_equal(a, b, epsilon: float = 1e-4) -> bool:
    def as_np(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return bool(np.max(np.abs(as_np(a) - as_np(b))) <= epsilon)
