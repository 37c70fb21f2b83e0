"""The system under test as the benchmark builds it: the port's config
node from a configuration file, its detector with the seed's weights, and
the plain settings that the reference reads of the same configuration.

Only this file and the drivers import the port (``odwscl_tpu_torch``);
the reference never does.
"""

from __future__ import annotations

from typing import Optional


def nested(dotted: dict) -> dict:
    """{"A.B": v} -> {"A": {"B": v}}."""
    out: dict = {}
    for key, value in dotted.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def build_cfg(config: dict, traffic: dict, extra: Optional[dict] = None):
    """The port's frozen config: its defaults, the configuration's
    published settings, its overrides, the traffic's, then ``extra``
    (dotted keys: the CPU tests' small sizes)."""
    from odwscl_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_other(config["cfg"])
    for over in (config.get("overrides"), traffic.get("overrides"), extra):
        if over:
            cfg.merge_from_other(nested(over))
    cfg.freeze()
    return cfg


def build_model(cfg, seed: int, device):
    """The port's detector on ``device`` with the seed's weights."""
    from odwscl_tpu_torch.models import build_model as port_build

    from . import weights

    model = port_build(cfg).to(device)
    weights.load_into(model, seed)
    return model


def reference_settings(cfg) -> dict:
    """The configuration's numbers that the reference needs, as plain
    values (the rules the program's ``detector_from_cfg`` states: the
    stage-B bank a quarter of the capacity, at least 64)."""
    cap = cfg.TPU.BANK_CAPACITY
    voc = cfg.DATASETS.TRAIN[0].startswith("voc_")
    return {
        "num_classes": cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
        "mlp_dim": cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
        "num_refs": cfg.MODEL.ROI_WEAK_HEAD.NUM_REFS,
        "pooled": cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
        "pooler_scale": cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES[0],
        "freeze_at": cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
        "reg_weights": tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS),
        "cap_a": cap, "cap_b": max(cap // 4, 64),
        "p_thres": cfg.thres, "mining_nms": cfg.nms, "lmda": cfg.lmda,
        "temperature": cfg.temp,
        "fg_iou": cfg.MODEL.ROI_HEADS.FG_IOU_THRESHOLD,
        "batch": cfg.SOLVER.IMS_PER_BATCH,
        "data_seed": cfg.SEED,
        "train_scales": tuple(cfg.INPUT.MIN_SIZE_TRAIN),
        "train_max": cfg.INPUT.MAX_SIZE_TRAIN,
        "size_div": cfg.DATALOADER.SIZE_DIVISIBILITY,
        "pad_multiple": cfg.TPU.IMAGE_PAD_MULTIPLE,
        "buckets": tuple(cfg.TPU.PROPOSAL_BUCKETS),
        "proposal_min_size": 20.0 if voc else 2.0,
        "base_lr": cfg.SOLVER.BASE_LR, "warmup_iters": cfg.SOLVER.WARMUP_ITERS,
        "warmup_factor": cfg.SOLVER.WARMUP_FACTOR,
        "lr_steps": tuple(cfg.SOLVER.STEPS), "gamma": cfg.SOLVER.GAMMA,
        "momentum": cfg.SOLVER.MOMENTUM,
        "weight_decay": cfg.SOLVER.WEIGHT_DECAY,
        "weight_decay_bias": cfg.SOLVER.WEIGHT_DECAY_BIAS,
        "bias_lr_factor": cfg.SOLVER.BIAS_LR_FACTOR,
        "test_min": cfg.INPUT.MIN_SIZE_TEST,
        "test_max": cfg.INPUT.MAX_SIZE_TEST,
        "tta_scales": tuple(cfg.TEST.BBOX_AUG.SCALES),
        "tta_max": cfg.TEST.BBOX_AUG.MAX_SIZE,
        "nms": cfg.MODEL.ROI_HEADS.NMS,
        "score_thresh": cfg.MODEL.ROI_HEADS.SCORE_THRESH,
        "detections": cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
    }


def model_shape(cfg) -> dict:
    """What the FLOP counts need of the model."""
    from .reference.model import FREEZE_CONV_COUNTS, VGG16_OICR

    at = cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT
    cap = cfg.TPU.BANK_CAPACITY
    return {"spec": VGG16_OICR, "frozen_convs":
            FREEZE_CONV_COUNTS[at - 1] if at else 0,
            "mlp_dim": cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
            "pooled": cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            "num_classes": cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            "num_refs": cfg.MODEL.ROI_WEAK_HEAD.NUM_REFS,
            "cap_a": cap, "cap_b": max(cap // 4, 64), "embed": 128}
