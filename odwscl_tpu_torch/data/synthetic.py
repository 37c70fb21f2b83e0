"""Write synthetic VOC- and COCO-layout splits and their proposal pickles,
and synthetic Caffe2 detectron ResNet weights.

The same layout and generator as ``tools/make_synthetic_voc.py``:
``<out>/voc/VOC2007/{JPEGImages,Annotations,ImageSets/Main}`` plus
Selective-Search-style proposal pickles (jittered GT boxes, then random
boxes), all from one seeded ``numpy.random.RandomState``: the test split
first (ids 1..n_test, one or two objects each), then the trainval split
(the next n_trainval ids, one to three labelled objects each). With
``trainval_first`` it writes ``tools/make_synthetic_voc.py:main``'s
dataset instead, draw for draw and byte for byte: trainval first (ids
1..n_trainval), then test, one or two objects each, every proposal kept
(the GT jitters can outnumber ``n_props``). Image size, proposal count
and box sizes are arguments, so the same writer serves small test sets
and VOC-sized runs.

    python -m odwscl_tpu_torch.data.synthetic --out DIR [--n-test N]
        [--n-trainval N] [--trainval-first ...]
    python -m odwscl_tpu_torch.data.synthetic --coco --out DIR \
        [--layout coco17|coco14|coco17_mcg] [--n-train N] [--n-val N] \
        [--n-valminusminival N] [--partial] [--web] ...

``write_synthetic_coco`` is ``tools/make_synthetic_coco.py``'s generator
(same draws, same files at its defaults): coloured rectangles as
objects, a quarter of their masks as compressed RLE and the rest as
polygons, 3x3 keypoint grids, proposals jittered around the GT and then
random. Its ``coco14`` and ``coco17_mcg`` layouts have COCO's 80 category
ids (1-90 with COCO's gaps) and the MCG proposal names of the shipped COCO
configs (configs/coco/coco{14,17}_contra_db_b8_lr0.01_mcg.yaml); it can add
the ``coco_2014_valminusminival`` split, ``point`` / ``scribble`` partial
labels (drawn from a second generator, so the rest is unchanged) and a web
dataset of image-level labels (``flickr_coco``).

``detectron_resnet_blobs`` makes the blobs of a detectron ImageNet ResNet
``.pkl`` (the layout ``utils/weight_import.py:import_detectron_resnet``
reads) with random values at trained-network scales, so that a warm start
from them trains without overflowing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Optional, Sequence, Tuple

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
               n_obj: Tuple[int, int] = (1, 3), cut_props: bool = True):
    """Images, annotations and the split list; returns (boxes, ids). Each
    image gets ``randint(*n_obj)`` objects and ``n_props`` proposals (more
    when its GT jitters outnumber them and not ``cut_props``)."""
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
        boxes_list.append(np.asarray(props[:n_props] if cut_props else props,
                                     np.float32))
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
                        "proposal/SS-voc07_trainval.pkl",
                        trainval_first: bool = False) -> str:
    """The VOC2007 ``test`` split (and a ``trainval`` split when
    ``n_trainval`` > 0) under ``out``; proposal files are paths relative to
    ``out``. ``trainval_first``: ``tools/make_synthetic_voc.py``'s layout
    (module docstring)."""
    rng = np.random.RandomState(seed)
    root = os.path.join(out, "voc", "VOC2007")
    if trainval_first:
        splits = [("trainval", range(1, n_trainval + 1), train_proposal_file,
                   (1, 3)),
                  ("test", range(n_trainval + 1, n_trainval + n_test + 1),
                   test_proposal_file, (1, 3))]
    else:
        splits = [("test", range(1, n_test + 1), test_proposal_file, (1, 3))]
        if n_trainval:
            splits.append(("trainval",
                           range(n_test + 1, n_test + n_trainval + 1),
                           train_proposal_file, (1, 4)))
    for split, id_range, pfile, n_obj in splits:
        ids = [f"{i:06d}" for i in id_range]
        boxes, img_ids = make_split(root, split, ids, rng, n_props, img_hw,
                                    prop_size, obj_size, n_obj,
                                    cut_props=not trainval_first)
        path = os.path.join(out, pfile)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_proposal_pickle(path, boxes, img_ids)
    return out


COCO17_CATS = ["person", "bicycle", "car", "motorcycle", "airplane", "bus"]
# COCO's 80 categories with their json ids (1-90; 12, 26, 29, 30, 45, 66,
# 68, 69, 71 and 83 are unused)
COCO_CATEGORIES = list(zip(
    [i for i in range(1, 91)
     if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)],
    ["person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
     "truck", "boat", "traffic light", "fire hydrant", "stop sign",
     "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
     "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
     "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
     "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
     "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
     "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
     "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
     "couch", "potted plant", "bed", "dining table", "toilet", "tv",
     "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
     "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
     "scissors", "teddy bear", "hair drier", "toothbrush"]))


def _coco_splits(year: str, props: str, names=("train", "val")) -> dict:
    """{split: (image dir, annotation file, proposal file)}; ``props``
    formats the proposal file name of a split."""
    img = {"valminusminival": "val"}
    return {s: (f"coco/{img.get(s, s)}{year}",
                f"coco/annotations/instances_{s}{year}.json",
                props.format(s)) for s in names}


# layout -> ({split: (image dir, annotation file, proposal file)}, [(json
# id, name)]): ``coco17`` is tools/make_synthetic_coco.py's (6 categories,
# SS proposals); ``coco14`` and ``coco17_mcg`` are the shipped COCO
# configs' (80 categories, MCG proposals)
COCO_LAYOUTS = {
    "coco17": (_coco_splits("2017", "proposal/SS-coco17_{}.pkl"),
               list(enumerate(COCO17_CATS, 1))),
    "coco14": (_coco_splits("2014", "proposal/MCG/coco/MCG-coco14_{}.pkl",
                            ("train", "val", "valminusminival")),
               COCO_CATEGORIES),
    "coco17_mcg": (_coco_splits("2017", "proposal/MCG/coco/MCG-coco17_{}.pkl"),
                   COCO_CATEGORIES),
}
WEB_DIR = "flickr_coco"
WEB_PROPOSAL_FILE = "proposal/flickr_coco.pkl"


def _partial_fields(rng: np.random.RandomState, x1: int, y1: int, ow: int,
                    oh: int, empty_scribble: float) -> dict:
    """A ``point`` click strictly inside the box and a ``scribble``
    polyline ([xs, ys], 2-5 points, empty with probability
    ``empty_scribble``) within it."""
    point = [float(rng.uniform(x1 + 1, x1 + ow - 2)),
             float(rng.uniform(y1 + 1, y1 + oh - 2))]
    n = rng.randint(2, 6)
    xs = rng.uniform(x1, x1 + ow - 1, n).round(1).tolist()
    ys = rng.uniform(y1, y1 + oh - 1, n).round(1).tolist()
    if rng.rand() < empty_scribble:
        xs, ys = [], []
    return {"point": point, "scribble": [xs, ys]}


def make_coco_split(root: str, img_dir: str, img_ids: Sequence[int],
                    rng: np.random.RandomState, categories, n_props: int,
                    img_hw: Tuple[int, int], obj_size: Tuple[int, int],
                    prop_size: Tuple[int, int], rle_fraction: float = 0.25,
                    partial_rng: Optional[np.random.RandomState] = None,
                    empty_scribble: float = 0.1):
    """One split's images under ``root/img_dir``; returns (json dict,
    proposal boxes, image ids). ``partial_rng`` adds ``point`` and
    ``scribble`` fields to every annotation."""
    from PIL import Image

    from ..structures.rle import rle_encode

    os.makedirs(os.path.join(root, img_dir), exist_ok=True)
    images, annotations = [], []
    boxes_list, ids_list = [], []
    ann_id = 1
    h, w = img_hw
    for img_id in img_ids:
        img = rng.uniform(0, 80, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):
            ow, oh = rng.randint(*obj_size), rng.randint(*obj_size)
            x1 = rng.randint(0, w - ow)
            y1 = rng.randint(0, h - oh)
            ci = rng.randint(len(categories))
            color = np.array([(ci * 37) % 255, (ci * 91) % 255,
                              (ci * 151) % 255], np.uint8)
            img[y1:y1 + oh, x1:x1 + ow] = color
            if rng.rand() < rle_fraction:
                m = np.zeros((h, w), np.uint8)
                m[y1:y1 + oh, x1:x1 + ow] = 1
                seg = rle_encode(m)
            else:
                seg = [[x1, y1, x1 + ow - 1, y1, x1 + ow - 1, y1 + oh - 1,
                        x1, y1 + oh - 1]]
            # a 3x3 grid of keypoints inside the box, padded to 17
            gx = np.linspace(x1 + 2, x1 + ow - 3, 3)
            gy = np.linspace(y1 + 2, y1 + oh - 3, 3)
            kps = []
            for yy in gy:
                for xx in gx:
                    kps += [float(xx), float(yy), 2]
            kps += [0.0, 0.0, 0] * (17 - 9)
            ann = {"id": ann_id, "image_id": int(img_id),
                   "category_id": categories[ci][0],
                   "bbox": [float(x1), float(y1), float(ow), float(oh)],
                   "area": float(ow * oh), "iscrowd": 0,
                   "segmentation": seg, "keypoints": kps,
                   "num_keypoints": 9}
            if partial_rng is not None:
                ann.update(_partial_fields(partial_rng, x1, y1, ow, oh,
                                           empty_scribble))
            annotations.append(ann)
            ann_id += 1
        Image.fromarray(img).save(os.path.join(root, img_dir,
                                               f"{img_id:012d}.jpg"))
        images.append({"id": int(img_id), "file_name": f"{img_id:012d}.jpg",
                       "height": h, "width": w})
        props = []
        for a in annotations:
            if a["image_id"] != img_id:
                continue
            x, y, bw, bh = a["bbox"]
            for _ in range(6):
                j = rng.randint(-6, 7, 4)
                props.append([max(x + j[0], 0), max(y + j[1], 0),
                              min(x + bw + j[2], w - 1),
                              min(y + bh + j[3], h - 1)])
        while len(props) < n_props:
            pw, ph = rng.randint(*prop_size), rng.randint(*prop_size)
            px = rng.randint(0, max(w - pw, 1))
            py = rng.randint(0, max(h - ph, 1))
            props.append([px, py, px + pw, py + ph])
        boxes_list.append(np.asarray(props, np.float32))
        ids_list.append(int(img_id))
    data = {"images": images, "annotations": annotations,
            "categories": [{"id": i, "name": n} for i, n in categories]}
    return data, boxes_list, ids_list


def write_synthetic_coco(out: str, n_train: int = 8, n_val: int = 4,
                         seed: int = 0, img_hw: Tuple[int, int] = (120, 144),
                         n_props: int = 64, layout: str = "coco17",
                         obj_size: Tuple[int, int] = (24, 56),
                         prop_size: Tuple[int, int] = (18, 60),
                         n_valminusminival: int = 0, partial: bool = False,
                         web: bool = False) -> str:
    """The train and val splits of ``layout`` under ``out`` (ids 1..n_train,
    then the next n_val), then, in ``coco14`` with ``n_valminusminival``,
    that split (the next ids, images beside val's). ``partial`` adds
    ``point`` / ``scribble`` fields drawn from ``RandomState(seed + 1)``.
    ``web`` writes the train split's images again as a web dataset
    (``flickr_coco``: image-level contiguous labels, no boxes) with a
    proposal file at ``WEB_PROPOSAL_FILE``."""
    splits, categories = COCO_LAYOUTS[layout]
    rng = np.random.RandomState(seed)
    partial_rng = np.random.RandomState(seed + 1) if partial else None
    counts = [("train", n_train), ("val", n_val)]
    if n_valminusminival:
        if "valminusminival" not in splits:
            raise ValueError(f"layout {layout} has no valminusminival split")
        counts.append(("valminusminival", n_valminusminival))
    first = 1
    for split, n in counts:
        img_dir, ann_file, prop_file = splits[split]
        data, boxes, ids = make_coco_split(
            out, img_dir, range(first, first + n), rng, categories, n_props,
            img_hw, obj_size, prop_size, partial_rng=partial_rng)
        first += n
        for path in (ann_file, prop_file):
            os.makedirs(os.path.dirname(os.path.join(out, path)),
                        exist_ok=True)
        with open(os.path.join(out, ann_file), "w") as f:
            json.dump(data, f)
        write_proposal_pickle(os.path.join(out, prop_file), boxes, ids)
        if web and split == "train":
            _write_web(out, img_dir, data, boxes, ids)
    return out


def _write_web(out: str, img_dir: str, data: dict, boxes, ids) -> None:
    """The split's images as ``flickr_coco``: each image's contiguous
    class ids as its labels, its proposals as they are."""
    contiguous = {c["id"]: i for i, c in enumerate(data["categories"], 1)}
    labels = {}
    for a in data["annotations"]:
        labels.setdefault(a["image_id"], set()).add(
            contiguous[a["category_id"]])
    os.makedirs(os.path.join(out, WEB_DIR), exist_ok=True)
    for im in data["images"]:
        shutil.copy(os.path.join(out, img_dir, im["file_name"]),
                    os.path.join(out, WEB_DIR, im["file_name"]))
    web = {"images": [{**im, "labels": sorted(labels[im["id"]])}
                      for im in data["images"]],
           "categories": data["categories"]}
    with open(os.path.join(out, WEB_DIR, "flickr_clean.json"), "w") as f:
        json.dump(web, f)
    write_proposal_pickle(os.path.join(out, WEB_PROPOSAL_FILE), boxes, ids)


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
    ap.add_argument("--trainval-first", action="store_true",
                    help="tools/make_synthetic_voc.py's layout")
    coco = ap.add_argument_group("COCO (--coco)")
    coco.add_argument("--coco", action="store_true")
    coco.add_argument("--layout", default="coco17", choices=COCO_LAYOUTS)
    coco.add_argument("--n-train", type=int, default=8)
    coco.add_argument("--n-val", type=int, default=4)
    coco.add_argument("--n-valminusminival", type=int, default=0)
    coco.add_argument("--obj-size", type=int, nargs=2, default=(24, 56))
    coco.add_argument("--prop-size", type=int, nargs=2, default=(18, 60))
    coco.add_argument("--partial", action="store_true",
                      help="add point and scribble fields")
    coco.add_argument("--web", action="store_true",
                      help="also write the train images as flickr_coco")
    a = ap.parse_args(argv)
    if a.coco:
        write_synthetic_coco(a.out, a.n_train, a.n_val, a.seed,
                             (a.img_h, a.img_w), a.n_props, a.layout,
                             tuple(a.obj_size), tuple(a.prop_size),
                             a.n_valminusminival, a.partial, a.web)
        print(f"synthetic COCO ({a.layout}) at {a.out}: {a.n_train} train, "
              f"{a.n_val} val, {a.n_valminusminival} valminusminival "
              f"images ({a.img_h}x{a.img_w}, {a.n_props} proposals)")
        return
    write_synthetic_voc(a.out, a.n_test, a.seed, (a.img_h, a.img_w),
                        a.n_props, test_proposal_file=a.test_proposal_file,
                        n_trainval=a.n_trainval,
                        train_proposal_file=a.train_proposal_file,
                        trainval_first=a.trainval_first)
    print(f"synthetic VOC at {a.out}: {a.n_test} test and {a.n_trainval} "
          f"trainval images ({a.img_h}x{a.img_w}, {a.n_props} proposals)")


if __name__ == "__main__":
    main()
