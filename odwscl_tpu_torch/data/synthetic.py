"""Write a synthetic VOC-layout test split and its proposal pickle.

The same layout and generator as ``tools/make_synthetic_voc.py``:
``<out>/voc/VOC2007/{JPEGImages,Annotations,ImageSets/Main}`` plus a
Selective-Search-style proposal pickle (jittered GT boxes, then random
boxes), all from one seeded ``numpy.random.RandomState``. Image size,
proposal count and box sizes are arguments, so the same writer serves
small test sets and VOC-sized eval runs.

    python -m odwscl_tpu_torch.data.synthetic --out DIR [--n-test N ...]
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
               obj_size: Tuple[int, int] = (30, 60)):
    """Images, annotations and the split list; returns (boxes, ids)."""
    from PIL import Image

    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    boxes_list, ids_list = [], []
    h, w = img_hw
    for img_id in ids:
        img = rng.uniform(0, 80, (h, w, 3)).astype(np.uint8)
        objects, gt = [], []
        for _ in range(rng.randint(1, 3)):
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
                        test_proposal_file: str = "proposal/SS-voc07_test.pkl"
                        ) -> str:
    """The VOC2007 ``test`` split under ``out``; the proposal file is a path
    relative to ``out``."""
    rng = np.random.RandomState(seed)
    root = os.path.join(out, "voc", "VOC2007")
    ids = [f"{i:06d}" for i in range(1, n_test + 1)]
    boxes, img_ids = make_split(root, "test", ids, rng, n_props, img_hw,
                                prop_size, obj_size)
    path = os.path.join(out, test_proposal_file)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_proposal_pickle(path, boxes, img_ids)
    return out


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
    a = ap.parse_args(argv)
    write_synthetic_voc(a.out, a.n_test, a.seed, (a.img_h, a.img_w),
                        a.n_props, test_proposal_file=a.test_proposal_file)
    print(f"synthetic VOC test split at {a.out}: {a.n_test} images "
          f"({a.img_h}x{a.img_w}, {a.n_props} proposals)")


if __name__ == "__main__":
    main()
