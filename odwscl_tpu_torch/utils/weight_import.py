"""Importers of the reference's torch and Caffe2 weights into the port.

Counterpart of ``odwscl_tpu/utils/weight_import.py``, with the same
explicit key mappings, written into the port's ``state_dict`` instead of
the flax tree. Each importer takes a ``state_dict`` and a path and returns
a new ``state_dict`` with the file's tensors in place (f32); a tensor of
another shape than the one it replaces raises ``ValueError``.

- ``import_vgg16_imagenet``: a torchvision or JCJOHNS VGG16 ImageNet
  ``.pth`` -> ``backbone.conv{i}`` and ``neck.fc6``/``fc7``;
- ``import_detectron_resnet``: a Caffe2 detectron ResNet ``.pkl`` -> the
  ResNet backbone (``models/resnet.py``);
- ``import_reference_checkpoint``: a trained reference OD-WSCL ``.pth``
  (VGG16) -> backbone, neck, SimNet and the eight MIST heads.

Torch convs and linears are already in the port's layout (OIHW, (out,
in)). Only fc6 is permuted: the reference flattens the pooled roi in
(C, 7, 7) order, the port's neck in (7, 7, C) order.
"""

from __future__ import annotations

import logging
import pickle
from typing import Dict, Mapping

import numpy as np
import torch

logger = logging.getLogger("odwscl_tpu_torch.weights")

# torchvision VGG16 ``features`` conv indices, in order conv0..conv12
_TV_VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

# the VGG16-OICR layer spec of the reference's ``make_layers``; its
# sequential module indices name the reference checkpoint's convs
_OICR_SPEC = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "I", "512-D", "512-D", "512-D"]


def _load_torch(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.replace("module.", ""): v.numpy() for k, v in obj.items()
            if hasattr(v, "numpy")}


def _same(w: np.ndarray) -> np.ndarray:
    return w


def _fc6(w: np.ndarray, channels: int = 512, res: int = 7) -> np.ndarray:
    """[O, C*r*r] with (C, h, w) input order -> [O, r*r*C] in (h, w, C)."""
    o = w.shape[0]
    return w.reshape(o, channels, res, res).transpose(0, 2, 3, 1).reshape(o,
                                                                          -1)


def _set(sd: dict, key: str, value) -> None:
    old = sd[key]
    value = np.asarray(value)
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {key}: {tuple(old.shape)} vs "
                         f"{value.shape}")
    sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))


def import_vgg16_imagenet(state_dict: Mapping[str, torch.Tensor], path: str
                          ) -> Dict[str, torch.Tensor]:
    """A torchvision/JCJOHNS VGG16 ImageNet ``.pth`` into the backbone
    (conv1_1..conv5_3) and the two classifier FCs (fc6, fc7)."""
    src = _load_torch(path)
    sd = dict(state_dict)
    # classifier.0/3 (torchvision) or classifier.1/4 (reference extractor)
    fc_keys = [("classifier.0", "classifier.3"),
               ("classifier.1", "classifier.4")]
    loaded = 0
    for i, tv in enumerate(_TV_VGG16_CONV_IDX):
        wk, bk = f"features.{tv}.weight", f"features.{tv}.bias"
        if wk in src:
            _set(sd, f"backbone.conv{i}.weight", src[wk])
            _set(sd, f"backbone.conv{i}.bias", src[bk])
            loaded += 1
    for fc6k, fc7k in fc_keys:
        if f"{fc6k}.weight" in src:
            _set(sd, "neck.fc6.weight", _fc6(src[f"{fc6k}.weight"]))
            _set(sd, "neck.fc6.bias", src[f"{fc6k}.bias"])
            _set(sd, "neck.fc7.weight", src[f"{fc7k}.weight"])
            _set(sd, "neck.fc7.bias", src[f"{fc7k}.bias"])
            loaded += 2
            break
    logger.info("Imported %d VGG16 layers from %s", loaded, path)
    if loaded < len(_TV_VGG16_CONV_IDX):
        logger.warning("Only %d/%d convs matched", loaded,
                       len(_TV_VGG16_CONV_IDX))
    return sd


# reference checkpoint key -> (port module, converter)
_REF_HEAD_MAP = {
    "roi_heads.feature_extractor.classifier.1": ("neck.fc6", _fc6),
    "roi_heads.feature_extractor.classifier.4": ("neck.fc7", _same),
    "roi_heads.model_sim.mlp.0": ("sim_net.mlp0", _same),
    "roi_heads.model_sim.mlp.2": ("sim_net.mlp1", _same),
}
_PRED_HEADS = ["cls_score", "det_score", "ref1", "ref2", "ref3",
               "bbox_pred1", "bbox_pred2", "bbox_pred3"]
# Caffe2 branch -> (port conv, port norm) within a block
_BRANCHES = {"branch2a": ("conv1", "bn1"), "branch2b": ("conv2", "bn2"),
             "branch2c": ("conv3", "bn3"),
             "branch1": ("downsample", "downsample_bn")}


def import_detectron_resnet(state_dict: Mapping[str, torch.Tensor],
                            path: str) -> Dict[str, torch.Tensor]:
    """A Caffe2 detectron ImageNet ResNet ``.pkl`` into the backbone.

    Caffe2 naming: ``conv1_w`` / ``res_conv1_bn_{s,b}``;
    ``res{S}_{B}_branch{1,2a,2b,2c}_w`` with ``_bn_{s,b}``. The norms are
    fused affines (their means and variances are folded in), so each
    ``FrozenBatchNorm`` takes ``scale`` and ``bias`` and keeps mean 0 and
    var 1. A blob without a place in the backbone (a stage it does not
    have) is skipped with a warning."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "blobs" in data:
        data = data["blobs"]
    sd = dict(state_dict)

    def set_bn(prefix: str, c2name: str) -> None:
        _set(sd, f"backbone.{prefix}.scale", data[c2name + "_s"])
        _set(sd, f"backbone.{prefix}.bias", data[c2name + "_b"])

    loaded = 0
    if "conv1_w" in data:
        _set(sd, "backbone.stem_conv.weight", data["conv1_w"])
        set_bn("stem_bn", "res_conv1_bn")
        loaded += 1
    for key in list(data.keys()):
        if not key.startswith("res") or not key.endswith("_w"):
            continue
        parts = key[:-2].split("_")  # e.g. res2_0_branch2a
        if len(parts) != 3:
            continue
        base = f"layer{int(parts[0][3:]) - 1}_{int(parts[1])}"  # res2: layer1
        conv_name, bn_name = _BRANCHES[parts[2]]
        try:
            _set(sd, f"backbone.{base}.{conv_name}.weight", data[key])
            set_bn(f"{base}.{bn_name}", key[:-2] + "_bn")
            loaded += 1
        except (KeyError, ValueError) as e:
            logger.warning("skip %s: %s", key, e)
    logger.info("Imported %d detectron ResNet tensors from %s", loaded, path)
    return sd


def import_reference_checkpoint(state_dict: Mapping[str, torch.Tensor],
                                path: str) -> Dict[str, torch.Tensor]:
    """A trained reference OD-WSCL checkpoint (``.pth``, VGG16-OICR) into
    the whole detector: backbone, neck, SimNet and the MIST heads."""
    src = _load_torch(path)
    sd = dict(state_dict)
    loaded = 0
    seq_idx, idx = [], 0
    for v in _OICR_SPEC:
        if v in ("M", "I"):
            idx += 1
        else:
            seq_idx.append(idx)
            idx += 2  # conv + relu
    for i, si in enumerate(seq_idx):
        wk = f"backbone.body.features.{si}.weight"
        if wk in src:
            _set(sd, f"backbone.conv{i}.weight", src[wk])
            _set(sd, f"backbone.conv{i}.bias",
                 src[f"backbone.body.features.{si}.bias"])
            loaded += 1
    for refk, (name, conv) in _REF_HEAD_MAP.items():
        if f"{refk}.weight" in src:
            _set(sd, f"{name}.weight", conv(src[f"{refk}.weight"]))
            _set(sd, f"{name}.bias", src[f"{refk}.bias"])
            loaded += 1
    for head in _PRED_HEADS:
        wk = f"roi_heads.predictor.{head}.weight"
        if wk in src:
            _set(sd, f"pred.{head}.weight", src[wk])
            _set(sd, f"pred.{head}.bias",
                 src[f"roi_heads.predictor.{head}.bias"])
            loaded += 1
    logger.info("Imported %d tensors from reference checkpoint %s", loaded,
                path)
    return sd
