"""Parallelism across processes: data-parallel training (``mesh``),
tensor-parallel neck serving (``tp``), spatially-parallel backbone
serving (``sp``)."""

from .mesh import (DataParallel, Mesh, ShardedBatch, all_gather_cat,
                   all_reduce_gradients, init_distributed, make_mesh)
from .sp import sp_backbone_apply, sp_bands, sp_stitch
from .tp import shard_neck_params, tp_neck_apply, tp_neck_plain

__all__ = ["DataParallel", "Mesh", "ShardedBatch", "all_gather_cat",
           "all_reduce_gradients", "init_distributed", "make_mesh",
           "sp_backbone_apply", "sp_bands", "sp_stitch", "shard_neck_params",
           "tp_neck_apply", "tp_neck_plain"]
