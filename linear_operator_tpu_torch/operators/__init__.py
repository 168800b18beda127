from ._linear_operator import LinearOperator
from .added_diag import AddedDiagLinearOperator
from .dense import DenseLinearOperator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator
from .kernel import (
    KernelLinearOperator,
    rbf_covar,
    rbf_fused_closure,
    rbf_fused_matvec,
    rbf_kernel_operator,
)
from .low_rank_root_added_diag import LowRankRootAddedDiagLinearOperator
from .root import LowRankRootLinearOperator, RootLinearOperator
from .sum import SumLinearOperator
from .triangular import TriangularLinearOperator

__all__ = [
    "AddedDiagLinearOperator",
    "ConstantDiagLinearOperator",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "KernelLinearOperator",
    "LinearOperator",
    "LowRankRootAddedDiagLinearOperator",
    "LowRankRootLinearOperator",
    "RootLinearOperator",
    "SumLinearOperator",
    "TriangularLinearOperator",
    "rbf_covar",
    "rbf_fused_closure",
    "rbf_fused_matvec",
    "rbf_kernel_operator",
]
