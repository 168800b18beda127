from ._linear_operator import LinearOperator
from .added_diag import AddedDiagLinearOperator
from .chol import CholLinearOperator
from .constant_mul import ConstantMulLinearOperator
from .dense import DenseLinearOperator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator
from .grid_interpolated import GridInterpolatedLinearOperator
from .interpolated import InterpolatedLinearOperator, InterpolationMatrix
from .kernel import (
    KernelLinearOperator,
    rbf_covar,
    rbf_fused_closure,
    rbf_fused_matvec,
    rbf_kernel_operator,
)
from .kronecker import (
    KroneckerProductDiagLinearOperator,
    KroneckerProductLinearOperator,
    KroneckerProductTriangularLinearOperator,
)
from .kronecker_added_diag import KroneckerProductAddedDiagLinearOperator
from .low_rank_root_added_diag import LowRankRootAddedDiagLinearOperator
from .matmul import MatmulLinearOperator
from .root import LowRankRootLinearOperator, RootLinearOperator
from .sum import SumLinearOperator
from .sum_kronecker import SumKroneckerLinearOperator
from .toeplitz import ToeplitzLinearOperator
from .triangular import TriangularLinearOperator

__all__ = [
    "AddedDiagLinearOperator",
    "CholLinearOperator",
    "ConstantDiagLinearOperator",
    "ConstantMulLinearOperator",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "GridInterpolatedLinearOperator",
    "InterpolatedLinearOperator",
    "InterpolationMatrix",
    "KernelLinearOperator",
    "KroneckerProductAddedDiagLinearOperator",
    "KroneckerProductDiagLinearOperator",
    "KroneckerProductLinearOperator",
    "KroneckerProductTriangularLinearOperator",
    "LinearOperator",
    "LowRankRootAddedDiagLinearOperator",
    "LowRankRootLinearOperator",
    "MatmulLinearOperator",
    "RootLinearOperator",
    "SumKroneckerLinearOperator",
    "SumLinearOperator",
    "ToeplitzLinearOperator",
    "TriangularLinearOperator",
    "rbf_covar",
    "rbf_fused_closure",
    "rbf_fused_matvec",
    "rbf_kernel_operator",
]
