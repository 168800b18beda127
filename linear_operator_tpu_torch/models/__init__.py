from .gp import ExactGPRegression, PosteriorCache, load_jax_cache, load_jax_params
from .ski import GridSpec, SKIGPRegression, SKIParams, load_jax_grid, make_grid

__all__ = [
    "ExactGPRegression",
    "GridSpec",
    "PosteriorCache",
    "SKIGPRegression",
    "SKIParams",
    "load_jax_cache",
    "load_jax_grid",
    "load_jax_params",
    "make_grid",
]
