"""Shared test helpers (counterpart of linear_operator_tpu/test/utils.py)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def approx_equal(a, b, epsilon: float = 1e-4) -> bool:
    def as_np(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return bool(np.max(np.abs(as_np(a) - as_np(b))) <= epsilon)


@contextlib.contextmanager
def local_device_mesh(n_devices: int | None = None, model: int = 1, *, device: str | torch.device = "cuda"):
    """Context manager yielding a (data, model) mesh over the ranks of the
    process group (one rank without one), entered as the ambient mesh:
    ``least_used_cuda_device``'s multi-device counterpart."""
    from ..parallel import make_mesh

    mesh = make_mesh(n_devices, model=model, device=device)
    with mesh:
        yield mesh
