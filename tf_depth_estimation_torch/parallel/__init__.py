"""Data parallelism over ``torch.distributed``: the port of
``tf_depth_estimation_tpu/parallel/``.

JAX runs one jit over a 1-D ``data`` mesh: parameters replicated, the batch sharded, and
XLA inserting the gradient all-reduce and the cross-device batch statistics. The port runs
one process a device, each with a replica of the model and its shard of the global batch
(``shard_batch``); ``make_dp_step`` makes the step of the global batch from a step of the
port's own, and ``dryrun.dryrun_multichip`` is the multi-device dry run.
"""
from tf_depth_estimation_torch.parallel.dp import (
    all_reduce_mean,
    average_gradients,
    init_process_group,
    is_primary,
    make_dp_step,
    replica_devices,
    shard_batch,
)

__all__ = ["all_reduce_mean", "average_gradients", "init_process_group", "is_primary",
           "make_dp_step", "replica_devices", "shard_batch"]
