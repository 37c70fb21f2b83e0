"""Weight bridge between the JAX package's flax parameters and the port.

The flax tree of ``odwscl_tpu.models.WSODDetector`` is
``{backbone: {conv{i}: {kernel, bias}}, neck: {fc6, fc7},
sim_net: {mlp0, mlp1}, pred: {<head>: {linear: {kernel, bias}}}}``; a
ResNet backbone holds ``stem_conv``, ``stem_bn`` and ``layer{s}_{b}``
blocks of bias-free convs and ``FrozenBatchNorm`` leaves ``scale``,
``bias``, ``mean`` and ``var``, which keep their names. With
``DB.METHOD concrete`` it also holds ``cdb: {conv1, conv2, downsample:
{kernel}, bn1, bn2: {scale, bias}}``, and with ``MODEL.FASTER_RCNN``
``cam: {cam_conv_kernel, cam_conv_bias}``. It is taken as nested dicts of
numpy arrays (with or without the outer ``params`` level) or as an
``.npz`` whose keys are the ``/``-joined paths.

- conv kernels go from HWIO to OIHW;
- Dense kernels go from (in, out) to (out, in);
- fc6 needs no permutation: the port flattens the pooled NHWC tensor in
  the same (h, w, c) order as the JAX neck;
- the heads of every predictor (WSDDN, OICR, MIST) drop the ``linear``
  level: ``pred/cls_score/linear/kernel`` becomes ``pred.cls_score.weight``;
- the CAM's (in, classes) kernel is the weight of ``cam.cam_conv``, a
  Linear over the NHWC features: ``cam/cam_conv_kernel`` becomes
  ``cam.cam_conv.weight`` (transposed), ``cam/cam_conv_bias``
  ``cam.cam_conv.bias``.

The supervised families keep the flax names as they are:
``SupervisedRCNN`` holds ``backbone`` (a VGG16 or ResNet body, an FPN
body ``backbone/{body, fpn}``, or an FBNet trunk ``backbone/{first,
stages/block{i}/{pw, dw, pwl, se/{fc1, fc2}}}`` of ``conv`` kernels and
``bn`` leaves) and ``roi_heads/{neck, box, mask, keypoint}`` (the keypoint
head: ``keypoint/{extractor/conv_fcn1..8, predictor/kps_score_lowres}``);
``RetinaNetDetector`` holds ``backbone/{body, fpn}`` and ``head``. A
grouped or depthwise HWIO kernel [kh, kw, in / groups, out] goes to OIHW
[out, in / groups, kh, kw], as any conv kernel. The mask head's
``conv5_mask`` and the keypoint head's ``kps_score_lowres`` are flax
``ConvTranspose`` layers (kernel [kh, kw, in, out], applied without the
spatial flip of a true transposed conv): torch's ``ConvTranspose2d``
weight [in, out, kh, kw] is that kernel flipped in both spatial axes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_MODULES = ("backbone", "neck", "sim_net", "pred", "cdb", "cam",
            "roi_heads", "head")
# flax ConvTranspose kernels (spatially flipped against torch's)
_TRANSPOSED = ("conv5_mask", "kps_score_lowres")
_LEAVES = ("kernel", "bias", "scale", "mean", "var", "cam_conv_kernel",
           "cam_conv_bias")
_CDB_CHILDREN = ("conv1", "conv2", "downsample", "bn1", "bn2")
_CAM_LEAVES = {"cam_conv_kernel": ["cam_conv", "kernel"],
               "cam_conv_bias": ["cam_conv", "bias"]}


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts, or a path to an ``.npz`` of ``/``-joined
    keys) -> the port's ``state_dict`` (f32 tensors)."""
    if isinstance(params, (str, bytes)) or hasattr(params, "__fspath__"):
        with np.load(params) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = flatten_tree(params)
    out = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts[0] not in _MODULES or parts[-1] not in _LEAVES:
            raise KeyError(f"no port parameter for flax leaf {key!r}")
        if parts[0] == "pred":
            if len(parts) != 4 or parts[2] != "linear":
                raise KeyError(f"unexpected predictor head leaf {key!r}")
            parts = [parts[0], parts[1], parts[3]]
        elif parts[0] == "cdb":
            if len(parts) != 3 or parts[1] not in _CDB_CHILDREN:
                raise KeyError(f"unexpected Concrete DropBlock leaf {key!r}")
        elif parts[0] == "cam":
            if len(parts) != 2 or parts[1] not in _CAM_LEAVES:
                raise KeyError(f"unexpected CAM leaf {key!r}")
            parts = ["cam", *_CAM_LEAVES[parts[1]]]
        elif parts[-1] in _CAM_LEAVES:
            raise KeyError(f"no port parameter for flax leaf {key!r}")
        v = np.asarray(v, np.float32)
        if parts[-1] == "kernel":
            if v.ndim == 4 and parts[-2] in _TRANSPOSED:
                v = v[::-1, ::-1].transpose(2, 3, 0, 1)   # -> [in, out, H, W]
            elif v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            elif v.ndim == 2:
                v = v.T                          # (in, out) -> (out, in)
            else:
                raise ValueError(f"kernel {key!r} has shape {v.shape}")
            parts[-1] = "weight"
        out[".".join(parts)] = torch.from_numpy(np.array(v, order="C"))
    return out


def jax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's ``state_dict`` -> the flax params tree
    (without the outer ``params`` level), numpy f32."""
    flat = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        v = t.detach().to("cpu", torch.float32).numpy()
        if parts[-1] == "weight":
            if v.ndim == 4 and parts[-2] in _TRANSPOSED:
                v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
            parts[-1] = "kernel"
        if parts[0] == "pred":
            parts = [parts[0], parts[1], "linear", parts[2]]
        elif parts[0] == "cam":
            parts = ["cam", f"cam_conv_{parts[2]}"]
        flat["/".join(parts)] = np.ascontiguousarray(v)
    return unflatten_tree(flat)


def save_npz(path: str, params) -> None:
    """Write a flax params tree as an ``.npz`` of ``/``-joined keys."""
    np.savez(path, **flatten_tree(params))
