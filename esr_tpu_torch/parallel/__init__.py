"""The parallel axes over ``torch.distributed`` (port of esr_tpu/parallel):
data parallelism, spatial (height) sharding, row-parallel channel TP of the
trunk, a GPipe pipeline of the trunk, and the multi-process helpers. One
process per device; see ``comm.py`` for the collectives and their gradients."""

from esr_tpu_torch.parallel.dp import batch_sharding, make_dp_train_step, replicated, shard_batch
from esr_tpu_torch.parallel.mesh import make_mesh, make_spatial_tp_mesh, make_stage_mesh, make_tp_mesh
from esr_tpu_torch.parallel.pipeline import pipelined_rrdb_apply, pipelined_trunk
from esr_tpu_torch.parallel.spatial import (
    spatial_fold_apply,
    spatial_sharded_forward,
    spatial_window_forward,
    tiled_forward,
)
from esr_tpu_torch.parallel.tensor import spatial_tp_apply, tp_rrdb_apply, tp_trunk

__all__ = [
    "batch_sharding",
    "make_dp_train_step",
    "make_mesh",
    "make_spatial_tp_mesh",
    "make_stage_mesh",
    "make_tp_mesh",
    "pipelined_rrdb_apply",
    "pipelined_trunk",
    "replicated",
    "shard_batch",
    "spatial_fold_apply",
    "spatial_sharded_forward",
    "spatial_tp_apply",
    "spatial_window_forward",
    "tiled_forward",
    "tp_rrdb_apply",
    "tp_trunk",
]
