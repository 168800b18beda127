from .gp import ExactGPRegression, PosteriorCache, load_jax_cache, load_jax_params

__all__ = ["ExactGPRegression", "PosteriorCache", "load_jax_cache", "load_jax_params"]
