"""Detections drawn on their images (``test_net --vis``).

Counterpart of ``odwscl_tpu/utils/visualize.py``, drawing with PIL as it
does: each detection at or above ``score_thresh``, highest score first, as
a 2-px rectangle in its class's colour with ``"<name> <score>"`` above it;
``vis_results`` saves one jpg an image.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

_COLORS = [(220, 20, 60), (0, 130, 200), (60, 180, 75), (255, 165, 0),
           (145, 30, 180), (0, 128, 128), (210, 105, 30), (128, 0, 0),
           (0, 0, 128), (128, 128, 0)]


def draw_detections(image: np.ndarray, dets: Dict[str, np.ndarray],
                    class_names: Optional[Sequence[str]] = None,
                    score_thresh: float = 0.3) -> np.ndarray:
    """image: HWC uint8 RGB; dets: {boxes [N, 4], scores [N], labels [N]}
    -> the annotated HWC uint8 image."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    boxes = np.asarray(dets["boxes"]).reshape(-1, 4)
    scores = np.asarray(dets["scores"])
    labels = np.asarray(dets["labels"])
    for i in np.argsort(-scores):
        if scores[i] < score_thresh:
            continue
        c = _COLORS[int(labels[i]) % len(_COLORS)]
        x1, y1, x2, y2 = boxes[i]
        draw.rectangle([x1, y1, x2, y2], outline=c, width=2)
        name = (class_names[int(labels[i])] if class_names
                else str(int(labels[i])))
        draw.text((x1 + 2, max(y1 - 10, 0)), f"{name} {scores[i]:.2f}",
                  fill=c)
    return np.asarray(img)


def vis_results(dets_per_image, images, output_dir: str,
                class_names=None, prefix: str = "vis",
                score_thresh: float = 0.3):
    """Save ``output_dir/<prefix>_<i:06d>.jpg`` for each image; returns the
    paths."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, (dets, img) in enumerate(zip(dets_per_image, images)):
        out = draw_detections(np.asarray(img), dets, class_names,
                              score_thresh)
        p = os.path.join(output_dir, f"{prefix}_{i:06d}.jpg")
        Image.fromarray(out).save(p)
        paths.append(p)
    return paths
