"""PyTorch and CUDA port of linear_operator_tpu: lazy linear operators,
preconditioned CG + SLQ, and exact-GP inference whose kernel mat-vecs run as
CUDA kernels written by hand for Hopper (``ops/rbf.py``, ``csrc/``).

The port covers the exact-GP marginal likelihood and posterior and their
gradients (the training step ``model.neg_mll(x, y, generator=g).backward()``),
with the pivoted-Cholesky or Nystrom preconditioner, the root decompositions
(Cholesky, eigendecomposition, Lanczos) and the LOVE prediction cache
(``model.posterior_cache`` once, then ``model.posterior_from_cache`` per
query batch), and the opt-in bf16 tile-cache solve of a large symmetric RBF
kernel operator (``operators.rbf_fused_closure``).
Its entry points run on a CUDA device unless the caller asks for the CPU,
where the kernels' plain PyTorch versions take their place.
"""

from . import settings
from .functions import (
    diagonalization,
    inv_quad_logdet,
    pivoted_cholesky,
    root_decomposition,
    root_inv_decomposition,
    solve,
)
from .models import ExactGPRegression, PosteriorCache, load_jax_cache, load_jax_params
from .operators import CholLinearOperator

__all__ = [
    "CholLinearOperator",
    "ExactGPRegression",
    "PosteriorCache",
    "diagonalization",
    "inv_quad_logdet",
    "load_jax_cache",
    "load_jax_params",
    "pivoted_cholesky",
    "root_decomposition",
    "root_inv_decomposition",
    "settings",
    "solve",
]
