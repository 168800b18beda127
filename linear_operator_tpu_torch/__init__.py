"""PyTorch and CUDA port of linear_operator_tpu: lazy linear operators,
preconditioned CG + SLQ, and exact-GP inference whose kernel mat-vecs run as
CUDA kernels written by hand for Hopper (``ops/rbf.py``, ``csrc/``).

The port covers the exact-GP marginal likelihood and posterior and their
gradients (the training step ``model.neg_mll(x, y, generator=g).backward()``),
with the pivoted-Cholesky or Nystrom preconditioner, the root decompositions
(Cholesky, eigendecomposition, Lanczos) and the LOVE prediction cache
(``model.posterior_cache`` once, then ``model.posterior_from_cache`` per
query batch), the opt-in bf16 tile-cache solve of a large symmetric RBF
kernel operator (``operators.rbf_fused_closure``), the exact Woodbury
operator (``LowRankRootLinearOperator(U).add_diagonal(d)``: closed-form
solves and log-determinants), contour-integral-quadrature sampling
(``sqrt_inv_matmul``, ``zero_mean_mvn_samples`` under
``settings.ciq_samples``, shifted MINRES) and the predictive distribution
(``model.posterior_distribution``, a ``MultivariateNormal``), and the
structured operators with the KISS-GP model on them: Kronecker products
(closed-form solves and log-determinants through the factors'
eigendecompositions), Toeplitz factors (dense or FFT mat-vecs),
interpolated operators (gather and scatter-add) and
``SKIGPRegression``, the inducing-point, classification, multitask and
deep-kernel models (``SGPRRegression``, ``SVGPRegression``,
``SVGPClassification``, ``SVGPPoissonRegression``,
``MultitaskGPRegression``, ``DeepKernelGPRegression``), and the kernel
operator's covariances: RBF, Matern and
the rational quadratic on the fused kernels, periodic and spectral mixture
on the blocked engine, multi-output and parameter-batched layouts, and
covariances registered at run time (``ops.register_tile_covar``), and the
sharded training step over data, model and probe axes on
``torch.distributed`` (``parallel``).
Its entry points run on a CUDA device unless the caller asks for the CPU,
where the kernels' plain PyTorch versions take their place.
"""

from . import beta_features, distributions, operators, settings, solvers, utils
from .distributions import MultivariateNormal
from .functions import (
    add_diagonal,
    add_jitter,
    diagonalization,
    dsmm,
    inv_quad,
    inv_quad_logdet,
    pivoted_cholesky,
    root_decomposition,
    root_inv_decomposition,
    solve,
    sqrt_inv_matmul,
)
from .models import (
    DeepKernelGPRegression,
    ExactGPRegression,
    GridSpec,
    MultitaskGPRegression,
    PosteriorCache,
    SGPRRegression,
    SKIGPRegression,
    SKIParams,
    SVGPClassification,
    SVGPPoissonRegression,
    SVGPRegression,
    load_jax_cache,
    load_jax_grid,
    load_jax_params,
    make_grid,
)
from .operators import (
    AddedDiagLinearOperator,
    BatchRepeatLinearOperator,
    BlockDiagLinearOperator,
    BlockInterleavedLinearOperator,
    BlockLinearOperator,
    CatLinearOperator,
    CholLinearOperator,
    ConstantDiagLinearOperator,
    ConstantMulLinearOperator,
    DenseLinearOperator,
    DiagLinearOperator,
    GridInterpolatedLinearOperator,
    IdentityLinearOperator,
    InterpolatedLinearOperator,
    InterpolationMatrix,
    KeOpsLinearOperator,
    KernelLinearOperator,
    KroneckerProductAddedDiagLinearOperator,
    KroneckerProductDiagLinearOperator,
    KroneckerProductLinearOperator,
    KroneckerProductTriangularLinearOperator,
    LinearOperator,
    LowRankRootAddedDiagLinearOperator,
    LowRankRootLinearOperator,
    MaskedLinearOperator,
    MatmulLinearOperator,
    MulLinearOperator,
    PermutationLinearOperator,
    PsdSumLinearOperator,
    RootLinearOperator,
    SumBatchLinearOperator,
    SumKroneckerLinearOperator,
    SumLinearOperator,
    ToeplitzLinearOperator,
    TransposePermutationLinearOperator,
    TriangularLinearOperator,
    ZeroLinearOperator,
    cat,
    matern_kernel_operator,
    periodic_kernel_operator,
    rbf_kernel_operator,
    rq_kernel_operator,
    spectral_mixture_kernel_operator,
    to_dense,
    to_linear_operator,
)

from . import parallel  # noqa: E402  (it imports the models)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "AddedDiagLinearOperator",
    "BatchRepeatLinearOperator",
    "BlockDiagLinearOperator",
    "BlockInterleavedLinearOperator",
    "BlockLinearOperator",
    "CatLinearOperator",
    "CholLinearOperator",
    "ConstantDiagLinearOperator",
    "ConstantMulLinearOperator",
    "DeepKernelGPRegression",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "ExactGPRegression",
    "GridInterpolatedLinearOperator",
    "GridSpec",
    "IdentityLinearOperator",
    "InterpolatedLinearOperator",
    "InterpolationMatrix",
    "KeOpsLinearOperator",
    "KernelLinearOperator",
    "KroneckerProductAddedDiagLinearOperator",
    "KroneckerProductDiagLinearOperator",
    "KroneckerProductLinearOperator",
    "KroneckerProductTriangularLinearOperator",
    "LinearOperator",
    "LowRankRootAddedDiagLinearOperator",
    "LowRankRootLinearOperator",
    "MaskedLinearOperator",
    "MatmulLinearOperator",
    "MulLinearOperator",
    "MultitaskGPRegression",
    "MultivariateNormal",
    "PermutationLinearOperator",
    "PosteriorCache",
    "PsdSumLinearOperator",
    "RootLinearOperator",
    "SGPRRegression",
    "SKIGPRegression",
    "SKIParams",
    "SVGPClassification",
    "SVGPPoissonRegression",
    "SVGPRegression",
    "SumBatchLinearOperator",
    "SumKroneckerLinearOperator",
    "SumLinearOperator",
    "ToeplitzLinearOperator",
    "TransposePermutationLinearOperator",
    "TriangularLinearOperator",
    "ZeroLinearOperator",
    "add_diagonal",
    "add_jitter",
    "beta_features",
    "cat",
    "diagonalization",
    "distributions",
    "dsmm",
    "inv_quad",
    "inv_quad_logdet",
    "load_jax_cache",
    "load_jax_grid",
    "load_jax_params",
    "make_grid",
    "matern_kernel_operator",
    "operators",
    "parallel",
    "periodic_kernel_operator",
    "pivoted_cholesky",
    "rbf_kernel_operator",
    "root_decomposition",
    "root_inv_decomposition",
    "rq_kernel_operator",
    "settings",
    "solve",
    "solvers",
    "spectral_mixture_kernel_operator",
    "sqrt_inv_matmul",
    "to_dense",
    "to_linear_operator",
    "utils",
]
