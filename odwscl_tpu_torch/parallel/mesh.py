"""Data-parallel training across processes that equals one process on the
global batch.

Counterpart of ``odwscl_tpu/parallel/mesh.py`` and of the JAX trainer's
batch sharding (``engine/trainer.py:82-140``): there the step is one
program over a mesh, and XLA computes the same global program as one
device on the whole batch. The main path couples the images of a batch
(stage A fills its slots across the batch, stage B's bank statistics and
SupConV2 run over every image's bank, the dropout and DropBlock draws are
drawn at [B*P] size from one generator), so per-rank losses averaged as
in a textbook DDP would train another model. Here:

- each rank loads its slice of the global batch (``data/samplers.py``),
  padded to the global batch's widths (``BatchCollator``'s ``agree``:
  one all-reduce(max) of the canvas, the proposal count and the GT,
  keypoint, click and scribble widths);
- each rank runs the batch-separable prefix, the backbone (with the FPN
  where the body has one), on its own images;
- the feature maps are all-gathered with autograd (``all_gather_cat``)
  and the small per-image fields without (``DataParallel.gather_batch``);
- every rank runs the rest of the step on the global batch with the same
  generator state, so every random draw is the one-process draw;
- after the backward the gradients are averaged over the ranks
  (``all_reduce_gradients``), a ``None`` gradient counting as zero.

The gradient scale: every rank computes the same global loss, so the
all-gather's backward sums world-size copies of each rank's feature
gradient; the mean over ranks then gives exactly the one-process gradient
for the tail and the backbone alike. A gather without autograd, or a sum
where the mean belongs, is off by the world size.

The tail runs on every rank, so this layout scales only the backbone.

``TPU.MESH_AXES`` is read as the JAX package reads it: ``data`` takes
every process, any other axis is sized 1 (``make_mesh``). The process
group: ``nccl`` for CUDA devices, ``gloo`` on the CPU, from the usual
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
or a ``file://`` init method.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.detector import Batch


def init_distributed(device="cuda", init_method: Optional[str] = None
                     ) -> Tuple[int, int]:
    """Join the process group (``nccl`` for a CUDA device, ``gloo``
    otherwise) and return (world size, rank). ``init_method`` defaults to
    ``env://`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
    a ``file://`` path also carries them when ``RANK`` and ``WORLD_SIZE``
    are set. On a CUDA device the rank's card is ``LOCAL_RANK`` (default
    the rank modulo the card count)."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    cuda = torch.device(device).type == "cuda"
    init_method = init_method or "env://"
    kw = {}
    if not init_method.startswith("env://"):
        kw = dict(rank=int(os.environ.get("RANK", "0")),
                  world_size=int(os.environ.get("WORLD_SIZE", "1")))
    if cuda:
        local = int(os.environ.get("LOCAL_RANK",
                                   int(os.environ.get("RANK", "0"))
                                   % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method, **kw)
    return dist.get_world_size(), dist.get_rank()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes of the process mesh: ``data`` spans every process."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def make_mesh(axis_names: Sequence[str] = ("data",)) -> Mesh:
    """The mesh of ``TPU.MESH_AXES``: the first axis takes every process
    of the group (one without a group), the others are sized 1."""
    world_size = dist.get_world_size() if dist.is_initialized() else 1
    names = tuple(axis_names)
    return Mesh(names, (world_size,) + (1,) * (len(names) - 1))


def collective_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under ``nccl``, the CPU under ``gloo``."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllGatherCat(torch.autograd.Function):
    """Concatenation over ranks along dim 0; the backward sums the
    gradient of the whole over the ranks and returns this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each) concatenated along dim 0 in
    rank order, differentiable: the backward reduces the gradient over
    the ranks."""
    return _AllGatherCat.apply(x, group)


def all_reduce_gradients(params: Iterable[torch.Tensor], group=None,
                         mean: bool = True) -> None:
    """Sum (``mean``: average) the gradients of ``params`` over the ranks
    with one all-reduce per dtype; a ``None`` gradient counts as zero and
    is set to the result."""
    params = list(params)
    world = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        dist.all_reduce(flat, group=group)
        if mean:
            flat.div_(world)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad = g.view_as(p)


@dataclasses.dataclass
class ShardedBatch:
    """This rank's batch (its images) and the global batch's small fields
    (``images`` None)."""

    local: Batch
    glob: Batch


class DataParallel:
    """The data-parallel step's collectives over ``group`` (default the
    whole world)."""

    def __init__(self, group=None):
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = collective_device(group)

    def agree_widths(self, widths: Dict[str, int]) -> Dict[str, int]:
        """The largest value of each width over the ranks (one
        all-reduce(max))."""
        keys = sorted(widths)
        t = torch.tensor([int(widths[k]) for k in keys], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return dict(zip(keys, t.tolist()))

    def gather_batch(self, local: Batch) -> ShardedBatch:
        """Every field but the images gathered over the ranks (rank order
        is the global batch's image order)."""
        fields = {f.name: getattr(local, f.name)
                  for f in dataclasses.fields(local) if f.name != "images"}
        glob = Batch(images=None, **{
            k: None if v is None else all_gather_cat(v, self.group)
            for k, v in fields.items()})
        return ShardedBatch(local, glob)

    def gather_features(self, feats):
        """The backbone's output (a map, or a list of FPN levels) of every
        rank, concatenated along the batch with autograd."""
        if isinstance(feats, (list, tuple)):
            return type(feats)(all_gather_cat(f, self.group) for f in feats)
        return all_gather_cat(feats, self.group)

    def average_gradients(self, optimizer) -> None:
        """Average the gradients of the optimizer's parameters."""
        all_reduce_gradients((p for g in optimizer.param_groups
                              for p in g["params"]), self.group)
