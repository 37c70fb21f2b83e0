"""Training CLI of the port, with ``tools/train_net.py``'s surface.

    python -m odwscl_tpu_torch.tools.train_net --config-file CFG \
        [--data-root DIR] [--skip-test] [--device cuda|cpu] \
        [--nms X --lmda X ...] [KEY VALUE ...]

The paper's flags (``--nms``, ``--lmda``, ``--iou``, ``--temp``,
``--thres``, ``--loss``, ...) set the config keys of the same lowercase
names. Training resumes from ``OUTPUT_DIR/last_checkpoint`` when there is
one; otherwise ``MODEL.WEIGHT`` names the warm start, on top of the
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
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

PAPER_FLAGS = [("nms", float), ("lmda", float), ("iou", float),
               ("temp", float), ("thres", float), ("loss", str),
               ("cluster", int), ("pos_update", int), ("min_size", float),
               ("cls_hp", float), ("reg_hp", float), ("lmda2", float)]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OD-WSCL training "
                                     "(PyTorch port)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--skip-test", action="store_true")
    parser.add_argument("--data-root", default="datasets")
    parser.add_argument("--device", default="cuda")
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
    with ``--skip-test``). ``timing_out`` (a dict) receives the loop's
    per-step times and losses (engine/trainer.py) under ``train`` and the
    evaluation's stage times under ``test``."""
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_train_loader
    from odwscl_tpu_torch.engine.trainer import do_train
    from odwscl_tpu_torch.models import build_model
    from odwscl_tpu_torch.solver import make_optimizer
    from odwscl_tpu_torch.tools.test_net import run_test
    from odwscl_tpu_torch.utils.checkpoint import Checkpointer
    from odwscl_tpu_torch.utils.device import resolve_device

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
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: "
                               "%(message)s")
    logger = logging.getLogger("odwscl_tpu_torch.train_net")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yml"), "w") as f:
        f.write(cfg.dump())

    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
    model.to(device)
    optimizer, _ = make_optimizer(
        cfg.SOLVER, model,
        cfg.SOLVER_CDB if cfg.DB.METHOD == "concrete" else None,
        cfg.DB.WEIGHT)
    generator = torch.Generator(device=device).manual_seed(cfg.SEED)
    ckpt = Checkpointer(cfg.OUTPUT_DIR)
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
    train_timing = {}
    do_train(model, optimizer, loader, cfg.SOLVER.MAX_ITER, device,
             generator, ckpt, cfg.SOLVER.CHECKPOINT_PERIOD,
             start_iter=start_iter, timing_out=train_timing,
             profile_iters=_profile_window(cfg.SOLVER.MAX_ITER, start_iter,
                                           device))
    if timing_out is not None:
        timing_out["train"] = train_timing
    if args.skip_test:
        return None
    test_timing = {}
    results = run_test(cfg, model, args.data_root, device,
                       timing_out=test_timing)
    if timing_out is not None:
        timing_out["test"] = test_timing
    return results


def _profile_window(max_iter: int, start_iter: int, device):
    """On the card, trace steps 5-20 of the run (after the warm-up) to
    read the device's idle share."""
    first = start_iter + 5
    if torch.device(device).type != "cuda" or first > max_iter:
        return None
    return first, min(max_iter, start_iter + 20)


if __name__ == "__main__":
    main()
