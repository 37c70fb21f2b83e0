"""Training CLI of the port, with ``tools/train_net.py``'s surface.

    python -m odwscl_tpu_torch.tools.train_net --config-file CFG \
        [--data-root DIR] [--skip-test] [--device cuda|cpu] \
        [--distributed [--dist-url URL]] [--use-tensorboard] \
        [--profile-dir DIR] [--nms X --lmda X ...] [KEY VALUE ...]

The paper's flags (``--nms``, ``--lmda``, ``--iou``, ``--temp``,
``--thres``, ``--loss``, ...) set the config keys of the same lowercase
names. Training resumes from ``OUTPUT_DIR/last_checkpoint`` when there is
one: a port ``.pt``, or the JAX package's Orbax checkpoint directory, so a
run of ``tools/train_net.py`` continues here from its ``OUTPUT_DIR`` (its
params, momentum traces, update counts and step are imported without
orbax, utils/checkpoint.py; its rng is not, the port's generator keeps
``cfg.SEED``'s stream); otherwise ``MODEL.WEIGHT`` names the warm start, on top of the
random init seeded by ``cfg.SEED``: a ``catalog://`` name resolves to
``<data-root>/weights/<basename of its URL>``; it raises if the file is
missing. A port ``.pt`` loads as it is; a Caffe2 ``.pkl`` goes to
``import_detectron_resnet``, a ``.pth`` whose basename lacks "model" to
``import_vgg16_imagenet`` and any other ``.pth`` to
``import_reference_checkpoint`` (utils/weight_import.py). ``MODEL.WEIGHT
""`` keeps the random init. With ``DB.METHOD concrete`` the Concrete
DropBlock trains adversarially on ``SOLVER_CDB``, scaled by ``DB.WEIGHT``
(solver/build.py). The model family follows the config
(``models.build_model``: RetinaNet, the WSOD detector, or the supervised
Fast / Mask R-CNN). Checkpoints go to ``OUTPUT_DIR``; unless
``--skip-test`` the trained model is then evaluated as
``tools/test_net.py`` does.

``--distributed`` (or a ``WORLD_SIZE`` above 1 in the environment) joins
a process group, ``nccl`` on the card and ``gloo`` on the CPU, from the
``torchrun``-style environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``; ``--dist-url file://PATH`` instead of
the address): each process trains on its share of every global batch of
``SOLVER.IMS_PER_BATCH`` images, and the step equals one process on the
global batch (parallel/mesh.py). Process r seeds the global generators
with ``SEED + r``; only process 0 logs to ``OUTPUT_DIR/log.txt``, writes
checkpoints and ``--use-tensorboard``'s ``OUTPUT_DIR/logs/scalars.jsonl``
(one record an iteration: ``iteration``, ``time``, ``data`` and the
losses and metrics); the evaluation is sharded and merged on process 0.
``--profile-dir DIR`` traces iterations 2-6 of the run with
``torch.profiler`` into ``DIR/worker<rank>.pt.trace.json``, with the
window's device idle share and the peak memory in
``DIR/window_rank<rank>.json`` on the card.
"""

from __future__ import annotations

import argparse
import os

import torch

PAPER_FLAGS = [("nms", float), ("lmda", float), ("iou", float),
               ("temp", float), ("thres", float), ("loss", str),
               ("cluster", int), ("pos_update", int), ("min_size", float),
               ("cls_hp", float), ("reg_hp", float), ("lmda2", float)]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="OD-WSCL training (PyTorch port). Resumes from "
        "OUTPUT_DIR/last_checkpoint when there is one: a port .pt, or the "
        "JAX package's Orbax checkpoint directory (params, momentum, counts "
        "and step imported; its rng not).")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--skip-test", action="store_true")
    parser.add_argument("--data-root", default="datasets")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--distributed", action="store_true",
                        help="join a process group (torchrun-style env)")
    parser.add_argument("--dist-url", default="env://",
                        help="the process group's init method (env:// or "
                             "file://PATH)")
    parser.add_argument("--use-tensorboard", action="store_true",
                        help="write OUTPUT_DIR/logs/scalars.jsonl")
    parser.add_argument("--profile-dir", default="",
                        help="trace iterations 2-6 into this directory")
    for flag, typ in PAPER_FLAGS:
        parser.add_argument(f"--{flag}", type=typ, default=None)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser


def update_iters(cfg) -> None:
    """SOLVER.ITER_SIZE = k makes a run k times as many iterations
    (MAX_ITER, CHECKPOINT_PERIOD). STEPS and WARMUP_ITERS are left as they
    are: the schedule counts updates, one per k iterations, so its
    milestones already fall at k * STEPS iterations. (The JAX CLI scales
    them too, which puts them at k^2 * STEPS.)"""
    k = cfg.SOLVER.ITER_SIZE
    if k > 1:
        cfg.SOLVER.MAX_ITER *= k
        cfg.SOLVER.CHECKPOINT_PERIOD *= k


def warm_start(cfg, model, data_root: str) -> str:
    """Load ``cfg.MODEL.WEIGHT`` into the model, or raise; returns the
    resolved path. The JAX CLI sends a ``.pkl`` to the reference-checkpoint
    importer, which cannot read it; here it goes to the Caffe2 importer."""
    from odwscl_tpu_torch.config.catalog import ModelCatalog
    from odwscl_tpu_torch.utils import weight_import as wi
    from odwscl_tpu_torch.utils.checkpoint import load_model_weights

    path = ModelCatalog.resolve_or_fail(cfg.MODEL.WEIGHT,
                                        os.path.join(data_root, "weights"))
    if path.endswith(".pt"):
        model.load_state_dict(load_model_weights(path))
        return path
    if path.endswith(".pkl"):
        importer = wi.import_detectron_resnet
    elif path.endswith(".pth") and "model" not in os.path.basename(path):
        importer = wi.import_vgg16_imagenet
    elif path.endswith(".pth"):
        importer = wi.import_reference_checkpoint
    else:
        raise ValueError(f"MODEL.WEIGHT {path}: expected a .pt, .pkl or "
                         ".pth file")
    model.load_state_dict(importer(model.state_dict(), path))
    return path


def main(argv=None, timing_out=None):
    """Train as the config says; returns the evaluation results (or None
    with ``--skip-test``, and on every process but 0). ``timing_out`` (a
    dict) receives the loop's per-step times and losses
    (engine/trainer.py) under ``train`` and the evaluation's stage times
    under ``test``."""
    import torch.distributed as dist

    from odwscl_tpu_torch.config import get_default_cfg

    args = build_parser().parse_args(argv)
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    for flag, _ in PAPER_FLAGS:
        if getattr(args, flag) is not None:
            cfg[flag] = getattr(args, flag)
    update_iters(cfg)
    cfg.freeze()
    from odwscl_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    joined = False
    if args.distributed or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from odwscl_tpu_torch.parallel.mesh import init_distributed
        joined = not dist.is_initialized()
        init_distributed(args.device, args.dist_url)
    try:
        return _train(cfg, args, device, timing_out)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(cfg, args, device, timing_out):
    import json

    import torch.distributed as dist

    from odwscl_tpu_torch.data.build import make_train_loader
    from odwscl_tpu_torch.engine.trainer import do_train
    from odwscl_tpu_torch.models import build_model
    from odwscl_tpu_torch.parallel.mesh import DataParallel, make_mesh
    from odwscl_tpu_torch.solver import make_optimizer
    from odwscl_tpu_torch.tools.test_net import run_test
    from odwscl_tpu_torch.utils.checkpoint import Checkpointer
    from odwscl_tpu_torch.utils.logging_utils import (JsonlLogger,
                                                      MetricLogger,
                                                      setup_logger)
    from odwscl_tpu_torch.utils.miscellaneous import (save_config,
                                                      seed_all_rng)

    dp = DataParallel() if dist.is_initialized() else None
    rank = 0 if dp is None else dp.rank
    if device.type == "cuda" and dp is not None:
        device = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("odwscl_tpu_torch", cfg.OUTPUT_DIR, rank)
    if dp is not None:
        mesh = make_mesh(tuple(cfg.TPU.MESH_AXES))
        logger.info("Process %d of %d on %s; mesh %s", rank, dp.world_size,
                    device, dict(zip(mesh.axis_names, mesh.shape)))
    if rank == 0:
        save_config(cfg, os.path.join(cfg.OUTPUT_DIR, "config.yml"))
    seed_all_rng(cfg.SEED + rank)

    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
    model.to(device)
    optimizer, _ = make_optimizer(
        cfg.SOLVER, model,
        cfg.SOLVER_CDB if cfg.DB.METHOD == "concrete" else None,
        cfg.DB.WEIGHT)
    generator = torch.Generator(device=device).manual_seed(cfg.SEED)
    ckpt = Checkpointer(cfg.OUTPUT_DIR, save=rank == 0)
    start_iter = 0
    if ckpt.has_checkpoint():
        start_iter = ckpt.load(model, optimizer, generator)
        logger.info("Resumed at iteration %d", start_iter)
    elif cfg.MODEL.WEIGHT:
        logger.info("Warm-started from %s",
                    warm_start(cfg, model, args.data_root))
    else:
        logger.warning("MODEL.WEIGHT is empty: training from a random init "
                       "(seed %d)", cfg.SEED)

    loader = make_train_loader(cfg, start_iter, args.data_root)
    meters = (JsonlLogger(os.path.join(cfg.OUTPUT_DIR, "logs"), start_iter)
              if args.use_tensorboard and rank == 0 else MetricLogger())
    window = ((start_iter + 2, start_iter + 6) if args.profile_dir
              else _profile_window(cfg.SOLVER.MAX_ITER, start_iter, device))
    train_timing = {}
    if args.profile_dir and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    do_train(model, optimizer, loader, cfg.SOLVER.MAX_ITER, device,
             generator, ckpt, cfg.SOLVER.CHECKPOINT_PERIOD,
             start_iter=start_iter, timing_out=train_timing,
             profile_iters=window, dp=dp, meters=meters,
             profile_dir=args.profile_dir)
    if args.profile_dir and device.type == "cuda":
        summary = {k: train_timing.get(k) for k in (
            "profile_wall_s", "device_busy_s", "device_idle_share")}
        summary.update(first_iter=window[0], last_iter=window[1],
                       max_memory_allocated_bytes=
                       torch.cuda.max_memory_allocated(device))
        with open(os.path.join(args.profile_dir,
                               f"window_rank{rank}.json"), "w") as f:
            json.dump(summary, f)
    if timing_out is not None:
        timing_out["train"] = train_timing
    if args.skip_test:
        return None
    test_timing = {}
    results = run_test(cfg, model, args.data_root, device,
                       timing_out=test_timing)
    if timing_out is not None:
        timing_out["test"] = test_timing
    return results if rank == 0 else None


def _profile_window(max_iter: int, start_iter: int, device):
    """On the card, trace steps 5-20 of the run (after the warm-up) to
    read the device's idle share."""
    first = start_iter + 5
    if torch.device(device).type != "cuda" or first > max_iter:
        return None
    return first, min(max_iter, start_iter + 20)


if __name__ == "__main__":
    main()
