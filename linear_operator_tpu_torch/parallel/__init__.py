"""Multi-GPU scale-out on ``torch.distributed``: meshes of ranks and the
sharded exact-GP training step (counterpart of
linear_operator_tpu/parallel/).

Batch dims go over the ``data`` axis, Hutchinson probes over ``probe``, the
matrix dimension N over ``model`` (a row-sharded mat-vec).  GSPMD inserts
the JAX package's collectives; here each is explicit, in ``_comm.py``: CG's
inner products and residual norms, its stopping flag, the SLQ sums, the
gradients and the loss's batch mean.
"""

from .scaling import mll_throughput, scaling_report
from .sharding import (
    initialize_distributed,
    make_mesh,
    maybe_shard_probes,
    shard_gp_batch,
    sharded_train_step,
)

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "maybe_shard_probes",
    "mll_throughput",
    "scaling_report",
    "shard_gp_batch",
    "sharded_train_step",
]
