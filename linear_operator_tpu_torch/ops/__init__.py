from .rbf import (
    TILE_COVARS,
    kernel_matvec,
    kernel_matvec_plain,
    kernel_matvec_sym,
    kernel_weighted,
    kernel_weighted_plain,
    rq_tile_covar,
    sym_matvec_supported,
)

__all__ = [
    "TILE_COVARS",
    "kernel_matvec",
    "kernel_matvec_plain",
    "kernel_matvec_sym",
    "kernel_weighted",
    "kernel_weighted_plain",
    "rq_tile_covar",
    "sym_matvec_supported",
]
