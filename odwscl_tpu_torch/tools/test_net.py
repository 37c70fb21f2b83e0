"""Evaluation CLI of the port, with ``tools/test_net.py``'s surface.

    python -m odwscl_tpu_torch.tools.test_net --config-file CFG \
        [--ckpt W | --weights W] [--task det|corloc] [--vis] [--int8] \
        [--data-root DIR] [--device cuda|cpu] [KEY VALUE ...]

``--ckpt`` (the JAX CLI's name) or ``--weights`` takes a port ``.pt`` (a
state_dict or a training checkpoint of ``tools/train_net.py``), an
``.npz`` of the JAX package's flax params (``/``-joined keys;
utils/from_jax.py), a trained reference OD-WSCL ``.pth``
(``import_reference_checkpoint``, VGG16) or a directory: the JAX package's
Orbax checkpoint (``OUTPUT_DIR/model_<iter:07d>`` of its train_net), whose
params are imported without orbax (utils/orbax_import.py). Without
either, the checkpoint that ``OUTPUT_DIR/last_checkpoint`` names is
evaluated (the port's ``.pt`` or the JAX package's Orbax directory), and
only when there is none a seeded random init (``cfg.SEED``), with a
warning. ``--int8`` sets ``TPU.INT8_EVAL``, ``INT8_EVAL_CONVS`` and
``INT8_STATIC`` (static int8 serving, VGG16; engine/inference.py);
``--vis`` draws the first 20 images' detections into
``OUTPUT_DIR/inference/<dataset>/vis``.
The model family follows the config (``models.build_model``); a
``MODEL.MASK_ON`` model is evaluated on bbox and segm. Results go to
``OUTPUT_DIR/inference/<dataset>/``, the log to
``OUTPUT_DIR/inference/log.txt``. Needs Pillow.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OD-WSCL evaluation "
                                     "(PyTorch port)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--weights", default=None,
                        help="port .pt (state_dict or training checkpoint), "
                             "flax-params .npz, reference .pth or the JAX "
                             "package's Orbax checkpoint directory")
    parser.add_argument("--ckpt", default=None,
                        help="a specific checkpoint (what --weights takes); "
                             "default OUTPUT_DIR's last_checkpoint (a port "
                             ".pt or a JAX Orbax directory)")
    parser.add_argument("--task", default="det", choices=["det", "corloc"])
    parser.add_argument("--vis", action="store_true",
                        help="draw the first images' detections")
    parser.add_argument("--int8", action="store_true",
                        help="static int8 serving (TPU.INT8_EVAL, "
                             "INT8_EVAL_CONVS, INT8_STATIC)")
    parser.add_argument("--data-root", default="datasets")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser


def load_model(cfg, weights=None):
    """The cfg's model (``models.build_model``) on the CPU, with
    ``weights`` or a random init seeded by ``cfg.SEED``."""
    from odwscl_tpu_torch.models import build_model
    from odwscl_tpu_torch.utils.checkpoint import load_model_weights
    from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax
    from odwscl_tpu_torch.utils.weight_import import \
        import_reference_checkpoint

    model = build_model(cfg)
    if weights is None:
        logging.getLogger("odwscl_tpu_torch").warning(
            "No weights given; evaluating a random init (seed %d)", cfg.SEED)
        model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
    elif weights.endswith(".npz"):
        model.load_state_dict(state_dict_from_jax(weights))
    elif weights.endswith(".pth"):
        model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
        model.load_state_dict(import_reference_checkpoint(
            model.state_dict(), weights))
    else:
        model.load_state_dict(load_model_weights(weights))
    return model


def resolve_weights(cfg, weights=None, ckpt=None):
    """The weights to evaluate: ``ckpt`` or ``weights`` (not both), else
    the checkpoint ``OUTPUT_DIR/last_checkpoint`` names, else None."""
    from odwscl_tpu_torch.utils.checkpoint import Checkpointer

    if weights is not None and ckpt is not None:
        raise ValueError("pass --ckpt or --weights, not both")
    given = ckpt if ckpt is not None else weights
    if given is not None:
        return given
    return Checkpointer(cfg.OUTPUT_DIR, save=False).last_checkpoint_path()


def run_test(cfg, model, data_root, device, task="det", timing_out=None,
             vis=False):
    """Evaluate ``model`` on every test dataset of the config; returns
    {dataset name: result dict}; ``timing_out`` (a dict) receives each
    dataset's stage times (engine/inference.py)."""
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.engine.inference import inference

    results = {}
    for name, loader in make_eval_loaders(cfg, data_root):
        out = os.path.join(cfg.OUTPUT_DIR, "inference", name)
        os.makedirs(out, exist_ok=True)
        timing = {}
        results[name] = inference(model, cfg, loader, loader.dataset, out,
                                  task=task, device=device, timing_out=timing,
                                  vis=vis)
        if timing_out is not None:
            timing_out[name] = timing
    return results


def main(argv=None, timing_out=None):
    """Parse ``argv``, evaluate every test dataset of the config and return
    {dataset name: result dict}. ``timing_out`` (a dict) receives each
    dataset's stage times (engine/inference.py)."""
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.utils.device import resolve_device
    from odwscl_tpu_torch.utils.dist import process_count_and_index
    from odwscl_tpu_torch.utils.logging_utils import setup_logger

    args = build_parser().parse_args(argv)
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.int8:
        cfg.merge_from_list(["TPU.INT8_EVAL", "True",
                             "TPU.INT8_EVAL_CONVS", "True",
                             "TPU.INT8_STATIC", "True"])
    cfg.freeze()
    device = resolve_device(args.device)
    logger = setup_logger("odwscl_tpu_torch",
                          os.path.join(cfg.OUTPUT_DIR, "inference"),
                          process_count_and_index()[1])
    weights = resolve_weights(cfg, args.weights, args.ckpt)
    if weights is not None:
        logger.info("Evaluating %s", weights)
    model = load_model(cfg, weights)
    return run_test(cfg, model, args.data_root, device, args.task,
                    timing_out, args.vis)


if __name__ == "__main__":
    main()
