from ._linear_operator import LinearOperator, to_dense, to_linear_operator
from .added_diag import AddedDiagLinearOperator
from .batch_repeat import BatchRepeatLinearOperator
from .block import BlockDiagLinearOperator, BlockInterleavedLinearOperator, BlockLinearOperator
from .cat import CatLinearOperator, cat
from .chol import CholLinearOperator
from .constant_mul import ConstantMulLinearOperator
from .dense import DenseLinearOperator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator
from .identity import IdentityLinearOperator
from .grid_interpolated import GridInterpolatedLinearOperator
from .interpolated import InterpolatedLinearOperator, InterpolationMatrix
from .kernel import (
    KeOpsLinearOperator,
    KernelLinearOperator,
    matern12_covar,
    matern32_covar,
    matern52_covar,
    matern_kernel_operator,
    periodic_covar,
    periodic_kernel_operator,
    rbf_covar,
    rbf_fused_closure,
    rbf_fused_matvec,
    rbf_kernel_operator,
    rq_covar,
    rq_kernel_operator,
    spectral_mixture_covar,
    spectral_mixture_kernel_operator,
)
from .kronecker import (
    KroneckerProductDiagLinearOperator,
    KroneckerProductLinearOperator,
    KroneckerProductTriangularLinearOperator,
)
from .kronecker_added_diag import KroneckerProductAddedDiagLinearOperator
from .low_rank_root_added_diag import LowRankRootAddedDiagLinearOperator
from .masked import MaskedLinearOperator
from .matmul import MatmulLinearOperator
from .mul import MulLinearOperator
from .permutation import PermutationLinearOperator, TransposePermutationLinearOperator
from .root import LowRankRootLinearOperator, RootLinearOperator
from .sum import PsdSumLinearOperator, SumLinearOperator
from .sum_batch import SumBatchLinearOperator
from .sum_kronecker import SumKroneckerLinearOperator
from .toeplitz import ToeplitzLinearOperator
from .triangular import TriangularLinearOperator
from .zero import ZeroLinearOperator

__all__ = [
    "AddedDiagLinearOperator",
    "BatchRepeatLinearOperator",
    "BlockDiagLinearOperator",
    "BlockInterleavedLinearOperator",
    "BlockLinearOperator",
    "CatLinearOperator",
    "CholLinearOperator",
    "ConstantDiagLinearOperator",
    "ConstantMulLinearOperator",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "GridInterpolatedLinearOperator",
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
    "PermutationLinearOperator",
    "PsdSumLinearOperator",
    "RootLinearOperator",
    "SumBatchLinearOperator",
    "SumKroneckerLinearOperator",
    "SumLinearOperator",
    "ToeplitzLinearOperator",
    "TransposePermutationLinearOperator",
    "TriangularLinearOperator",
    "ZeroLinearOperator",
    "cat",
    "matern12_covar",
    "matern32_covar",
    "matern52_covar",
    "matern_kernel_operator",
    "periodic_covar",
    "periodic_kernel_operator",
    "rbf_covar",
    "rbf_fused_closure",
    "rbf_fused_matvec",
    "rbf_kernel_operator",
    "rq_covar",
    "rq_kernel_operator",
    "spectral_mixture_covar",
    "spectral_mixture_kernel_operator",
    "to_dense",
    "to_linear_operator",
]
