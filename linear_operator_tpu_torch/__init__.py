"""PyTorch and CUDA port of linear_operator_tpu: lazy linear operators,
preconditioned CG + SLQ, and exact-GP inference whose kernel mat-vecs run as
CUDA kernels written by hand for Hopper (``ops/rbf.py``, ``csrc/``).

The port covers the exact-GP marginal likelihood and posterior and their
gradients (the training step ``model.neg_mll(x, y, generator=g).backward()``).
Its entry points run on a CUDA device unless the caller asks for the CPU,
where the kernels' plain PyTorch versions take their place.
"""

from . import settings
from .functions import inv_quad_logdet, solve
from .models import ExactGPRegression, load_jax_params

__all__ = ["ExactGPRegression", "inv_quad_logdet", "load_jax_params", "settings", "solve"]
