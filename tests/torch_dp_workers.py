"""Multi-process helpers of the port's data-parallel, TP and SP tests (not
collected): ``run_ranks`` (or ``start_ranks`` and ``join_ranks``, to run
groups at once) spawns ``world`` processes that join a ``gloo``
group through a ``file://`` init method under the test's tmp_path (no
fixed port, so concurrent test workers cannot collide), run one of the
functions below and return each rank's result. The children import torch
and the port only.

- ``train``: ``make_train_loader`` + ``do_train`` for a config; with a
  process group the data-parallel step (parallel/mesh.py), without one
  the one-process reference. ``fault="sum"`` injects the missing mean
  (each rank's gradient summed, not averaged).
- ``train_batches``: ``do_train`` over given global batches, each rank
  taking its share.
- ``step_jax_batch``: one data-parallel step on a given batch, weights
  and draws (the JAX-parity case).
- ``tp``, ``sp``: the serving modules on each rank; ``sp_bodies``: the
  spatially-parallel ResNet, FPN and FBNet bodies, several cases a spawn.
"""

from __future__ import annotations

import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entry(rank, world, init_file, fn_name, args, out_dir):
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    torch.set_num_threads(1)
    from odwscl_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", "file://" + init_file)
    try:
        res = globals()[fn_name](*args)
        with open(os.path.join(out_dir, f"{fn_name}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world, tmp, fn_name, *args, timeout_s=300.0):
    """``fn_name(*args)`` on ``world`` gloo processes; [result of rank r].
    Raises when a rank fails or the ranks outlast ``timeout_s`` (then they
    are terminated)."""
    return join_ranks(start_ranks(world, tmp, fn_name, *args),
                      timeout_s=timeout_s)


def start_ranks(world, tmp, fn_name, *args):
    """``run_ranks`` without the wait: a handle for ``join_ranks``, so
    that groups of several world sizes can run at once."""
    tmp = str(tmp)
    init = os.path.join(tmp, f"init_{fn_name}_{world}_{os.getpid()}")
    ctx = mp.spawn(_entry, args=(world, init, fn_name, args, tmp),
                   nprocs=world, join=False)
    return ctx, world, tmp, fn_name


def join_ranks(handle, timeout_s=300.0):
    ctx, world, tmp, fn_name = handle
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"{fn_name} on {world} ranks outlasted "
                               f"{timeout_s} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{fn_name}_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def cfg_of(config, opts):
    from odwscl_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, config))
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def _model(cfg, head_scale=1.0):
    from odwscl_tpu_torch.models import build_model

    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
    if head_scale != 1.0:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("pred.") and "bbox" not in name \
                        and name.endswith("weight"):
                    p.mul_(head_scale)
    return model


def _sum_gradients(dp):
    from odwscl_tpu_torch.parallel.mesh import all_reduce_gradients

    def average_gradients(optimizer):
        all_reduce_gradients((p for g in optimizer.param_groups
                              for p in g["params"]), dp.group, mean=False)
    return average_gradients


def _dp(fault=None):
    from odwscl_tpu_torch.parallel.mesh import DataParallel

    if not dist.is_initialized():
        return None
    dp = DataParallel()
    if fault == "sum":
        dp.average_gradients = _sum_gradients(dp)
    return dp


def _record_bank(store):
    """Wrap the detector's stage A to record which images fill the bank."""
    import odwscl_tpu_torch.models.detector as det

    orig = det.stage_a

    def stage_a(*a, **kw):
        out = orig(*a, **kw)
        store.append(sorted(set(out.slot_b[out.slot_valid].tolist())))
        return out
    det.stage_a = stage_a


def _chunked_features(model, chunks):
    """Make ``model.train_features`` run its batch in ``chunks`` pieces
    (as ``chunks`` ranks would) and concatenate them."""
    whole = model.train_features

    def train_features(images):
        parts = [whole(x) for x in images.chunk(chunks)]
        if isinstance(parts[0], (list, tuple)):
            return type(parts[0])(torch.cat(level) for level in zip(*parts))
        return torch.cat(parts)
    model.train_features = train_features


def train(config, opts, data_root, jobs, head_scale=1.0, chunks=1):
    """For each fault of ``jobs`` (None or "sum"): a fresh seeded model
    trained ``SOLVER.MAX_ITER`` steps; returns [{"steps", "params",
    "init", "bank_images"}] (params of rank 0 only). ``chunks`` > 1 (one
    process) runs the backbone in that many pieces of the batch."""
    from odwscl_tpu_torch.data.build import make_train_loader
    from odwscl_tpu_torch.engine.trainer import do_train
    from odwscl_tpu_torch.solver import make_optimizer

    cfg = cfg_of(config, opts)
    banks = []
    _record_bank(banks)
    out = []
    for fault in jobs:
        model = _model(cfg, head_scale)
        if chunks > 1:
            _chunked_features(model, chunks)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        optimizer, _ = make_optimizer(cfg.SOLVER, model)
        generator = torch.Generator().manual_seed(cfg.SEED)
        timing = {}
        del banks[:]
        do_train(model, optimizer, make_train_loader(cfg, 0, data_root),
                 cfg.SOLVER.MAX_ITER, "cpu", generator, log_period=0,
                 timing_out=timing, dp=_dp(fault))
        keep = not dist.is_initialized() or dist.get_rank() == 0
        out.append({"steps": timing["steps"], "bank_images": list(banks),
                    "params": model.state_dict() if keep else None,
                    "init": init if keep else None})
    return out


def train_batches(config, opts, batches):
    """``do_train`` over the global ``batches`` (dicts of numpy fields),
    each rank taking its share; returns the steps' logs."""
    from odwscl_tpu_torch.engine.trainer import do_train
    from odwscl_tpu_torch.models import Batch
    from odwscl_tpu_torch.solver import make_optimizer
    from odwscl_tpu_torch.utils.dist import (process_count_and_index,
                                             rank_slice)

    cfg = cfg_of(config, opts)
    model = _model(cfg)
    optimizer, _ = make_optimizer(cfg.SOLVER, model)
    pc, pi = process_count_and_index()
    local = []
    for b in batches:
        share = rank_slice(len(b["images"]), pc, pi)
        local.append(Batch(**{k: torch.from_numpy(v[share])
                              for k, v in b.items()}))
    timing = {}
    do_train(model, optimizer, local, len(batches), "cpu",
             torch.Generator().manual_seed(cfg.SEED), log_period=0,
             timing_out=timing, dp=_dp())
    return timing["steps"]


def step_jax_batch(kw, freeze_at, state_path, batch, draws, solver_opts):
    """One data-parallel ``train_step`` of a ``WSODDetector(**kw)`` from
    the state_dict at ``state_path`` on the global ``batch`` (numpy
    fields; each rank takes its share) with the global ``draws``; returns
    (logs, state_dict)."""
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.engine.trainer import train_step
    from odwscl_tpu_torch.models import Batch, WSODDetector
    from odwscl_tpu_torch.solver import make_optimizer
    from odwscl_tpu_torch.utils.dist import (process_count_and_index,
                                             rank_slice)

    model = WSODDetector(**kw, freeze_at=freeze_at)
    model.load_state_dict(torch.load(state_path, weights_only=True))
    cfg = get_default_cfg()
    cfg.merge_from_list(list(solver_opts))
    optimizer, _ = make_optimizer(cfg.SOLVER, model)
    pc, pi = process_count_and_index()
    share = rank_slice(len(batch["images"]), pc, pi)
    local = Batch(**{k: torch.from_numpy(v[share]) for k, v in batch.items()})
    dp = _dp()
    logs = train_step(model, optimizer, dp.gather_batch(local),
                      draws={k: torch.from_numpy(v)
                             for k, v in draws.items()}, dp=dp)
    return ({k: float(v) for k, v in logs.items()},
            model.state_dict() if pi == 0 else None)


def tp(params, x, reduce=True):
    """``tp_neck_apply`` of this rank's shard of the neck ``params``
    ({fc6,fc7}.{weight,bias}, numpy) on ``x``; ``reduce=False`` drops the
    all-reduce (the fault the tests must catch)."""
    from torch import nn

    from odwscl_tpu_torch.parallel import tp as tpm

    neck = nn.ModuleDict({"fc6": nn.Linear(*params["fc6.weight"].shape[::-1]),
                          "fc7": nn.Linear(*params["fc7.weight"].shape[::-1])})
    neck.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    shard = tpm.shard_neck_params(neck, dist.get_rank(), dist.get_world_size())
    if not reduce:
        tpm.dist.all_reduce = lambda *a, **k: None
    out = tpm.tp_neck_apply(shard, torch.from_numpy(x), None, torch.float32)
    return out.numpy()


def _conv_rows(rows):
    """A mode that appends the rows of every ``F.conv2d`` input to
    ``rows``."""
    from torch.overrides import TorchFunctionMode

    class ConvRows(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.nn.functional.conv2d:
                rows.append(int(args[0].shape[2]))
            return func(*args, **(kwargs or {}))

    return ConvRows()


def sp(arch, state, images, gather=True):
    """``sp_backbone_apply`` of a ``VGGBackbone(arch)`` with ``state`` on
    ``images`` (numpy); returns (features, the rows of each conv's input
    in call order, seen by a hook on ``torch.nn.functional.conv2d``)."""
    from odwscl_tpu_torch.models.vgg16 import VGGBackbone
    from odwscl_tpu_torch.parallel.sp import sp_backbone_apply

    bb = VGGBackbone(arch, torch.float32)
    bb.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    rows = []
    with torch.no_grad(), _conv_rows(rows):
        out = sp_backbone_apply(bb, torch.from_numpy(images), None,
                                gather=gather)
    return out.numpy(), rows


def sp_bodies(cases):
    """``sp_backbone_apply`` of each case (kind, constructor kwargs, the
    path of an ``.npz`` of its state, images, gather): [(the outputs as a
    list of numpy arrays, the rows of the first conv's input)], f32 on the
    CPU."""
    import numpy as np

    from odwscl_tpu_torch.models import fbnet, fpn, resnet
    from odwscl_tpu_torch.parallel.sp import sp_backbone_apply

    kinds = {"ResNetBackbone": resnet.ResNetBackbone,
             "ResNetFPNBackbone": fpn.ResNetFPNBackbone,
             "ResNetFPNP3P7Backbone": fpn.ResNetFPNP3P7Backbone,
             "FBNetTrunk": fbnet.FBNetTrunk}
    out = []
    for kind, kw, state, images, gather in cases:
        bb = kinds[kind](**kw, compute_dtype=torch.float32)
        with np.load(state) as f:
            bb.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})
        rows = []
        with torch.no_grad(), _conv_rows(rows):
            got = sp_backbone_apply(bb, torch.from_numpy(images), None,
                                    gather=gather)
        got = got if isinstance(got, tuple) else (got,)
        out.append(([g.numpy() for g in got], rows[0]))
    return out
