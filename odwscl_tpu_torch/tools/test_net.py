"""Evaluation CLI of the port, with ``tools/test_net.py``'s surface.

    python -m odwscl_tpu_torch.tools.test_net --config-file CFG \
        [--weights W.pt|W.npz] [--task det|corloc] [--data-root DIR] \
        [--device cuda|cpu] [KEY VALUE ...]

``--weights`` takes a port ``.pt`` state_dict or an ``.npz`` of the JAX
package's flax params (``/``-joined keys; utils/from_jax.py). Without
weights the model is a seeded random init (``cfg.SEED``) and a warning is
logged. Results go to ``OUTPUT_DIR/inference/<dataset>/``. Needs Pillow.
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
                        help="port .pt state_dict or flax-params .npz")
    parser.add_argument("--task", default="det", choices=["det", "corloc"])
    parser.add_argument("--data-root", default="datasets")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser


def load_model(cfg, weights=None):
    """The cfg's detector on the CPU, with ``weights`` or a random init
    seeded by ``cfg.SEED``."""
    from odwscl_tpu_torch.models.detector import detector_from_cfg
    from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax

    model = detector_from_cfg(cfg)
    if weights is None:
        logging.getLogger("odwscl_tpu_torch").warning(
            "No weights given; evaluating a random init (seed %d)", cfg.SEED)
        model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
    elif weights.endswith(".npz"):
        model.load_state_dict(state_dict_from_jax(weights))
    else:
        model.load_state_dict(torch.load(weights, map_location="cpu",
                                         weights_only=True))
    return model


def main(argv=None, timing_out=None):
    """Parse ``argv``, evaluate every test dataset of the config and return
    {dataset name: result dict}. ``timing_out`` (a dict) receives each
    dataset's stage times (engine/inference.py)."""
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.engine.inference import inference
    from odwscl_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: "
                               "%(message)s")

    model = load_model(cfg, args.weights)
    results = {}
    for name, loader in make_eval_loaders(cfg, args.data_root):
        out = os.path.join(cfg.OUTPUT_DIR, "inference", name)
        os.makedirs(out, exist_ok=True)
        timing = {}
        results[name] = inference(model, cfg, loader, loader.dataset, out,
                                  task=args.task, device=device,
                                  timing_out=timing)
        if timing_out is not None:
            timing_out[name] = timing
    return results


if __name__ == "__main__":
    main()
