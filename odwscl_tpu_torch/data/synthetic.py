"""Write synthetic VOC-layout test and trainval splits and their proposal
pickles, and synthetic Caffe2 detectron ResNet weights.

The same layout and generator as ``tools/make_synthetic_voc.py``:
``<out>/voc/VOC2007/{JPEGImages,Annotations,ImageSets/Main}`` plus
Selective-Search-style proposal pickles (jittered GT boxes, then random
boxes), all from one seeded ``numpy.random.RandomState``: the test split
first (ids 1..n_test, one or two objects each), then the trainval split
(the next n_trainval ids, one to three labelled objects each). Image size,
proposal count and box sizes are arguments, so the same writer serves
small test sets and VOC-sized runs.

    python -m odwscl_tpu_torch.data.synthetic --out DIR [--n-test N]
        [--n-trainval N ...]

``detectron_resnet_blobs`` makes the blobs of a detectron ImageNet ResNet
``.pkl`` (the layout ``utils/weight_import.py:import_detectron_resnet``
reads) with random values at trained-network scales, so that a warm start
from them trains without overflowing.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence, Tuple

import numpy as np

from .proposals import write_proposal_pickle

VOC_CLASSES = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
               "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor"]

XML_TMPL = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>
"""
OBJ_TMPL = """<object>
    <name>{name}</name><difficult>{difficult}</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>"""


def make_split(root: str, split: str, ids: Sequence[str],
               rng: np.random.RandomState, n_props: int = 64,
               img_hw: Tuple[int, int] = (120, 144),
               prop_size: Tuple[int, int] = (22, 70),
               obj_size: Tuple[int, int] = (30, 60),
               n_obj: Tuple[int, int] = (1, 3)):
    """Images, annotations and the split list; returns (boxes, ids). Each
    image gets ``randint(*n_obj)`` objects."""
    from PIL import Image

    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    boxes_list, ids_list = [], []
    h, w = img_hw
    for img_id in ids:
        img = rng.uniform(0, 80, (h, w, 3)).astype(np.uint8)
        objects, gt = [], []
        for _ in range(rng.randint(*n_obj)):
            ow, oh = rng.randint(*obj_size), rng.randint(*obj_size)
            x1 = rng.randint(0, w - ow)
            y1 = rng.randint(0, h - oh)
            cls_idx = rng.randint(len(VOC_CLASSES))
            color = np.array([(cls_idx * 37) % 255, (cls_idx * 91) % 255,
                              (cls_idx * 151) % 255], np.uint8)
            img[y1:y1 + oh, x1:x1 + ow] = color
            gt.append((x1, y1, x1 + ow - 1, y1 + oh - 1))
            objects.append(OBJ_TMPL.format(
                name=VOC_CLASSES[cls_idx], difficult=0,
                x1=x1 + 1, y1=y1 + 1, x2=x1 + ow, y2=y1 + oh))  # 1-based
        Image.fromarray(img).save(os.path.join(root, "JPEGImages",
                                               f"{img_id}.jpg"))
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"),
                  "w") as f:
            f.write(XML_TMPL.format(w=w, h=h, objects="\n  ".join(objects)))
        props = []
        for (x1, y1, x2, y2) in gt:
            for _ in range(6):
                j = rng.randint(-8, 9, 4)
                props.append([max(x1 + j[0], 0), max(y1 + j[1], 0),
                              min(x2 + j[2], w - 1), min(y2 + j[3], h - 1)])
        while len(props) < n_props:
            pw, ph = rng.randint(*prop_size), rng.randint(*prop_size)
            px = rng.randint(0, max(w - pw, 1))
            py = rng.randint(0, max(h - ph, 1))
            props.append([px, py, px + pw, py + ph])
        boxes_list.append(np.asarray(props[:n_props], np.float32))
        ids_list.append(int(img_id))
    with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"),
              "w") as f:
        f.write("\n".join(str(i) for i in ids) + "\n")
    return boxes_list, ids_list


def write_synthetic_voc(out: str, n_test: int = 4, seed: int = 0,
                        img_hw: Tuple[int, int] = (120, 144),
                        n_props: int = 64,
                        prop_size: Tuple[int, int] = (22, 70),
                        obj_size: Tuple[int, int] = (30, 60),
                        test_proposal_file: str = "proposal/SS-voc07_test.pkl",
                        n_trainval: int = 0,
                        train_proposal_file: str =
                        "proposal/SS-voc07_trainval.pkl") -> str:
    """The VOC2007 ``test`` split (and a ``trainval`` split when
    ``n_trainval`` > 0) under ``out``; proposal files are paths relative to
    ``out``."""
    rng = np.random.RandomState(seed)
    root = os.path.join(out, "voc", "VOC2007")
    splits = [("test", range(1, n_test + 1), test_proposal_file, (1, 3))]
    if n_trainval:
        splits.append(("trainval", range(n_test + 1, n_test + n_trainval + 1),
                       train_proposal_file, (1, 4)))
    for split, id_range, pfile, n_obj in splits:
        ids = [f"{i:06d}" for i in id_range]
        boxes, img_ids = make_split(root, split, ids, rng, n_props, img_hw,
                                    prop_size, obj_size, n_obj)
        path = os.path.join(out, pfile)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_proposal_pickle(path, boxes, img_ids)
    return out


def detectron_resnet_blobs(depth: str = "R-50", stages_out: int = 5,
                           seed: int = 0) -> dict:
    """{Caffe2 blob name: f32 array} for every conv and norm of the port's
    ``ResNetBackbone(depth, stages_out)``: ``conv1_w``,
    ``res_conv1_bn_{s,b}``, ``res{S}_{B}_branch{1,2a,2b,2c}_w`` and their
    ``_bn_{s,b}``. Convs are Kaiming-normal (fan-out); norm biases are
    uniform in [-0.1, 0.1), norm scales in [0.5, 1.5) except on each
    block's residual branch's last norm, [0.05, 0.25), so that the
    activations stay bounded through the blocks as a trained network's
    do."""
    import torch

    from ..models.resnet import ResNetBackbone
    from ..utils.weight_import import _BRANCHES

    branch = {}
    for br, (conv, bn) in _BRANCHES.items():
        branch[conv], branch[bn] = br, br + "_bn"
    with torch.device("meta"):
        backbone = ResNetBackbone(depth, stages_out)
    last = "branch2b_bn" if depth == "R-18" else "branch2c_bn"
    rng = np.random.default_rng(seed)
    blobs = {}
    for key, t in backbone.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if leaf in ("mean", "var"):
            continue
        if mod in ("stem_conv", "stem_bn"):
            name = "conv1" if mod == "stem_conv" else "res_conv1_bn"
        else:
            layer, sub = mod.split(".")
            stage, block = layer[len("layer"):].split("_")
            name = f"res{int(stage) + 1}_{block}_{branch[sub]}"
        shape = tuple(t.shape)
        if leaf == "weight":
            fan_out = shape[0] * shape[2] * shape[3]
            v = rng.standard_normal(shape, np.float32) * (2.0 / fan_out) ** 0.5
        elif leaf == "scale":
            v = rng.uniform(*((0.05, 0.25) if name.endswith(last)
                              else (0.5, 1.5)), shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        blobs[name + {"weight": "_w", "scale": "_s", "bias": "_b"}[leaf]] = \
            np.asarray(v, np.float32)
    return blobs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-test", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--img-h", type=int, default=120)
    ap.add_argument("--img-w", type=int, default=144)
    ap.add_argument("--n-props", type=int, default=64)
    ap.add_argument("--test-proposal-file",
                    default="proposal/SS-voc07_test.pkl")
    ap.add_argument("--n-trainval", type=int, default=0)
    ap.add_argument("--train-proposal-file",
                    default="proposal/SS-voc07_trainval.pkl")
    a = ap.parse_args(argv)
    write_synthetic_voc(a.out, a.n_test, a.seed, (a.img_h, a.img_w),
                        a.n_props, test_proposal_file=a.test_proposal_file,
                        n_trainval=a.n_trainval,
                        train_proposal_file=a.train_proposal_file)
    print(f"synthetic VOC at {a.out}: {a.n_test} test and {a.n_trainval} "
          f"trainval images ({a.img_h}x{a.img_w}, {a.n_props} proposals)")


if __name__ == "__main__":
    main()
