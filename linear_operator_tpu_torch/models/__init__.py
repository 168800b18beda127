from .gp import ExactGPRegression, load_jax_params

__all__ = ["ExactGPRegression", "load_jax_params"]
