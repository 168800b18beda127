from .classification import SVGPClassification, SVGPPoissonRegression, gauss_hermite_expectation
from .dkl import DeepKernelGPRegression, DKLParams, MLPParams, init_mlp, mlp_features
from .gp import ExactGPRegression, GPParams, PosteriorCache, load_jax_cache, load_jax_params
from .multitask import MultitaskGPParams, MultitaskGPRegression
from .sgpr import SGPRParams, SGPRRegression
from .ski import GridSpec, SKIGPRegression, SKIParams, load_jax_grid, make_grid
from .svgp import SVGPParams, SVGPRegression

__all__ = [
    "DKLParams",
    "DeepKernelGPRegression",
    "ExactGPRegression",
    "GPParams",
    "GridSpec",
    "MLPParams",
    "MultitaskGPParams",
    "MultitaskGPRegression",
    "PosteriorCache",
    "SGPRParams",
    "SGPRRegression",
    "SKIGPRegression",
    "SKIParams",
    "SVGPClassification",
    "SVGPPoissonRegression",
    "SVGPParams",
    "SVGPRegression",
    "gauss_hermite_expectation",
    "init_mlp",
    "load_jax_cache",
    "load_jax_grid",
    "load_jax_params",
    "make_grid",
    "mlp_features",
]
