"""Keypoint R-CNN's head: conv tower, deconv heatmap predictor, loss and
the heatmap decode.

Counterpart of ``odwscl_tpu/models/keypoint_head.py``:
``KeypointFeatureExtractor`` (``conv_fcn1..8``: 3x3 convs of 512 channels
+ ReLU), ``KeypointPredictor`` (``kps_score_lowres``, a 4x4 stride-2
transposed conv to K channels, then a bilinear x2 upsample),
``KeypointHead``, ``keypoint_rcnn_loss`` and ``heatmaps_to_keypoints``.

The head maps pooled rois [N, r, r, C] (NHWC) to logits [N, 4r, 4r, K]
(28 x 28 on the shared 7x7 pool, as the JAX package designs it). flax's
``ConvTranspose`` k4 s2 ``SAME`` pads (2, 2) and applies its kernel as
stored; torch's ``ConvTranspose2d(k=4, s=2, p=1)`` has the same geometry
and flips its weight, so the weight is the flax kernel flipped in both
spatial axes (``utils/from_jax.py``). ``jax.image.resize`` linear x2 is
``F.interpolate(bilinear, align_corners=False)`` (half-pixel centres; at
the border both give the edge value).

The decode resizes each roi's heatmaps to the roi's size on the tensors'
device. The JAX package resizes with ``cv2.resize(INTER_CUBIC)``; the port
with ``F.interpolate(bicubic, align_corners=False)``: both are Keys'
cubic with a = -0.75, half-pixel centres and a replicated border, so the
maps agree to float drift and the argmax may move only where two cells
tie within it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .fpn import conv_nchw
from .mask_head import kaiming_normal_fan_out


class KeypointFeatureExtractor(nn.Module):
    """``conv_fcn{i}``: 3x3 convs + ReLU, on the NCHW view."""

    def __init__(self, in_channels: int,
                 conv_layers: Sequence[int] = (512,) * 8):
        super().__init__()
        self.n = len(conv_layers)
        cin = in_channels
        for i, ch in enumerate(conv_layers, 1):
            setattr(self, f"conv_fcn{i}", nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch
        self.out_channels = cin

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(1, self.n + 1):
            m = getattr(self, f"conv_fcn{i}")
            kaiming_normal_fan_out(m, generator, m.out_channels * 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n + 1):
            x = F.relu(conv_nchw(getattr(self, f"conv_fcn{i}"), x))
        return x


class KeypointPredictor(nn.Module):
    """``kps_score_lowres`` (4x4 stride-2 transposed conv, padding 1) and
    the bilinear x2: NCHW [N, D, r, r] -> [N, K, 4r, 4r] f32."""

    def __init__(self, in_channels: int, num_keypoints: int = 17):
        super().__init__()
        self.kps_score_lowres = nn.ConvTranspose2d(
            in_channels, num_keypoints, 4, stride=2, padding=1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        m = self.kps_score_lowres
        kaiming_normal_fan_out(m, generator, m.out_channels * 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.kps_score_lowres
        x = F.conv_transpose2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype),
                               stride=2, padding=1)
        return F.interpolate(x.to(torch.float32), scale_factor=2,
                             mode="bilinear", align_corners=False)


class KeypointHead(nn.Module):
    """extractor + predictor: pooled [N, r, r, C] -> logits [N, 4r, 4r, K]
    (an NHWC view), f32."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_layers: Sequence[int] = (512,) * 8,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.extractor = KeypointFeatureExtractor(in_channels, conv_layers)
        self.predictor = KeypointPredictor(self.extractor.out_channels,
                                           num_keypoints)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.extractor.reset_parameters(generator)
        self.predictor.reset_parameters(generator)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.to(self.compute_dtype).permute(0, 3, 1, 2)
        return self.predictor(self.extractor(x)).permute(0, 2, 3, 1)


def keypoint_rcnn_loss(kp_logits: torch.Tensor, heatmap_targets: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over each keypoint's heatmap cells at its target cell,
    averaged over the valid keypoints (0 without any). kp_logits [N, H, H,
    K] f32, heatmap_targets [N, K] (flat cell), valid [N, K] in {0, 1}."""
    n, h, w, k = kp_logits.shape
    logits = kp_logits.permute(0, 3, 1, 2).reshape(n * k, h * w)
    targets = heatmap_targets.reshape(n * k).long().clamp(min=0)
    v = valid.reshape(n * k).to(torch.float32)
    top = logits.max(dim=1).values
    logz = torch.log(torch.exp(logits - top[:, None]).sum(dim=1)) + top
    picked = logits.gather(1, targets[:, None])[:, 0]
    return ((logz - picked) * v).sum() / v.sum().clamp(min=1.0)


def heatmaps_to_keypoints(maps: torch.Tensor, rois):
    """Decode heatmaps to keypoints (Heckbert's d + 0.5): maps [N, H, H, K]
    on any device, rois [N, 4] -> numpy (xy_preds [N, K, 3] with
    visibility 1, scores [N, K]). Each roi's maps are resized to its
    ceil'd size (at least 1 px) on the maps' device; the results come to
    the host in one copy."""
    rois = np.asarray(torch.as_tensor(rois).detach().cpu(), np.float32)
    n, _, _, k = maps.shape
    widths = np.maximum(rois[:, 2] - rois[:, 0], 1)
    heights = np.maximum(rois[:, 3] - rois[:, 1], 1)
    widths_ceil = np.ceil(widths).astype(int)
    heights_ceil = np.ceil(heights).astype(int)
    nchw = maps.to(torch.float32).permute(0, 3, 1, 2)
    pos = torch.zeros((n, k), dtype=torch.int64, device=maps.device)
    score = torch.zeros((n, k), dtype=torch.float32, device=maps.device)
    for i in range(n):
        size = (int(heights_ceil[i]), int(widths_ceil[i]))
        roi_map = F.interpolate(nchw[i:i + 1], size=size, mode="bicubic",
                                align_corners=False)[0].reshape(k, -1)
        # the first maximum, as numpy's argmax
        score[i], pos[i] = roi_map.max(dim=1)
    pos, score = pos.cpu().numpy(), score.cpu().numpy()
    # the JAX package's host arithmetic, value for value
    xy_preds = np.zeros((n, 3, k), np.float32)
    for i in range(n):
        rw, rh = int(widths_ceil[i]), int(heights_ceil[i])
        x_int = pos[i] % rw
        y_int = (pos[i] - x_int) // rw
        xy_preds[i, 0] = (x_int + 0.5) * (widths[i] / rw) + rois[i, 0]
        xy_preds[i, 1] = (y_int + 0.5) * (heights[i] / rh) + rois[i, 1]
        xy_preds[i, 2] = 1
    return np.transpose(xy_preds, [0, 2, 1]), score
