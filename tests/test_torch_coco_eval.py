"""The port's COCO bbox evaluator against the JAX package's, on the CPU.

``do_coco_evaluation`` of both packages on the same json and predictions,
24 seeded random cases: 2-6 images, 8 categories with gapped json ids,
0-9 GT boxes an image of every area range (small, medium, large; the
``area`` field present or not), crowd GT, classes with GT and no
detections, detections and no GT, or neither, up to 260 detections an
image (more than MAX_DETS 100 in a class), score ties. Each area range's
AP, AP50, AP75, AR and its [10, 101, K] precisions (recorded from
``evaluate_coco_bbox``) and the returned stats agree within 1e-12 (they
are the same float64 operations in the same order; observed equal).

Goldens: every GT predicted exactly gives AP 1.0 in each populated area
range; boxes shifted far off give AP 0. CorLoc on a COCO dataset: the JAX
package raises an AttributeError (``dataset.CLASSES``), the port a
ValueError; the segm task without each prediction's ``masks`` raises in
both (a KeyError in the JAX package, a ValueError in the port; the segm
task itself is held in tests/test_torch_mask_rcnn.py).
"""

import json

import numpy as np
import pytest

from odwscl_tpu.data.coco_dataset import COCODataset as JCOCODataset
from odwscl_tpu.evaluation import coco_eval as jeval
from odwscl_tpu.evaluation import voc_eval as jvoc
from odwscl_tpu_torch.data.coco_dataset import COCODataset
from odwscl_tpu_torch.evaluation import coco_eval as teval
from odwscl_tpu_torch.evaluation import voc_eval as tvoc

ATOL = 1e-12
CAT_IDS = [1, 3, 7, 12, 13, 40, 77, 90]
N_CASES = 24


def _case(seed):
    """(json dict, predictions) of one random case."""
    rng = np.random.RandomState(seed)
    n_img = rng.randint(2, 7)
    images, anns = [], []
    preds = []
    live = rng.choice(len(CAT_IDS), 5, replace=False)   # classes with GT
    for k in range(n_img):
        img_id = 1000 + 7 * k + seed
        images.append({"id": img_id, "file_name": f"{img_id}.jpg",
                       "height": 480, "width": 640})
        gts = []
        for _ in range(rng.randint(0, 10)):
            side = rng.choice([rng.uniform(4, 30), rng.uniform(33, 95),
                               rng.uniform(98, 300)])
            w, h = side * rng.uniform(0.6, 1.4), side * rng.uniform(0.6, 1.4)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            ci = live[rng.randint(len(live))]
            a = {"id": len(anns) + 1, "image_id": img_id,
                 "category_id": CAT_IDS[ci], "bbox": [x, y, w, h],
                 "iscrowd": int(rng.rand() < 0.15)}
            if rng.rand() < 0.7:
                a["area"] = float(w * h * rng.uniform(0.5, 1.0))
            anns.append(a)
            gts.append((x, y, w, h, ci + 1))
        boxes, labels = [], []
        for x, y, w, h, c in gts:          # jittered hits
            for _ in range(rng.randint(0, 4)):
                j = rng.uniform(-0.25, 0.25, 4) * [w, h, w, h]
                boxes.append([x + j[0], y + j[1], x + w - 1 + j[2],
                              y + h - 1 + j[3]])
                labels.append(c if rng.rand() < 0.9 else rng.randint(1, 9))
        n_rand = rng.choice([0, 5, 40, 260])
        for _ in range(n_rand):             # false positives, any class
            x1, y1 = rng.uniform(0, 600), rng.uniform(0, 440)
            boxes.append([x1, y1, x1 + rng.uniform(2, 200),
                          y1 + rng.uniform(2, 200)])
            labels.append(rng.randint(1, 9) if rng.rand() < 0.5
                          else live[0] + 1)
        scores = rng.rand(len(boxes))
        scores[rng.rand(len(boxes)) < 0.3] = 0.5        # ties
        preds.append({"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                      "scores": scores.astype(np.float32),
                      "labels": np.asarray(labels, np.int64)})
    data = {"images": images, "annotations": anns,
            "categories": [{"id": i, "name": f"c{i}"} for i in CAT_IDS]}
    return data, preds


def _datasets(tmp_path, data):
    path = str(tmp_path / "ann.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return (COCODataset(path, str(tmp_path), False),
            JCOCODataset(path, str(tmp_path), False))


def _run(mod, ds, preds, mp):
    """do_coco_evaluation's stats and each area's evaluate_coco_bbox
    output."""
    areas = []
    inner = mod.evaluate_coco_bbox

    def record(*args, **kw):
        out = inner(*args, **kw)
        areas.append(out)
        return out

    mp.setattr(mod, "evaluate_coco_bbox", record)
    return mod.do_coco_evaluation(ds, preds), areas


@pytest.mark.parametrize("seed", range(N_CASES))
def test_coco_eval_matches_jax(tmp_path, seed):
    data, preds = _case(seed)
    ds, jds = _datasets(tmp_path, data)
    with pytest.MonkeyPatch.context() as mp:
        got, got_areas = _run(teval, ds, preds, mp)
        want, want_areas = _run(jeval, jds, preds, mp)
    assert set(got) == set(want) == {"AP", "AP50", "AP75", "AR", "AP_s",
                                     "AP_m", "AP_l"}
    for k in want:
        assert abs(got[k] - want[k]) <= ATOL, (k, got[k], want[k])
    assert len(got_areas) == len(want_areas) == 4
    for g, w in zip(got_areas, want_areas):
        for k in ("AP", "AP50", "AP75", "AR"):
            assert abs(g[k] - w[k]) <= ATOL, k
        np.testing.assert_allclose(g["precisions"], w["precisions"], rtol=0,
                                   atol=ATOL)


def test_cases_cover_the_hard_parts():
    """The random cases hold crowds, missing area fields, empty classes and
    more than MAX_DETS detections in one image and class."""
    crowds = no_area = over = 0
    empty = set()
    for seed in range(N_CASES):
        data, preds = _case(seed)
        crowds += sum(a["iscrowd"] for a in data["annotations"])
        no_area += sum("area" not in a for a in data["annotations"])
        with_gt = {a["category_id"] for a in data["annotations"]}
        empty |= set(CAT_IDS) - with_gt
        for p in preds:
            over += int(np.bincount(p["labels"]).max(initial=0)
                        > teval.MAX_DETS)
    assert crowds and no_area and over and empty


def _golden(shift):
    data, _ = _case(0)
    preds = []
    for im in data["images"]:
        boxes, labels = [], []
        for a in data["annotations"]:
            if a["image_id"] == im["id"] and not a["iscrowd"]:
                x, y, w, h = a["bbox"]
                boxes.append([x + shift, y, x + w - 1 + shift, y + h - 1])
                labels.append(CAT_IDS.index(a["category_id"]) + 1)
        preds.append({"boxes": np.asarray(boxes).reshape(-1, 4),
                      "scores": np.ones(len(boxes)),
                      "labels": np.asarray(labels, np.int64)})
    return data, preds


@pytest.mark.parametrize("shift,ap", [(0.0, 1.0), (2000.0, 0.0)])
def test_coco_eval_goldens(tmp_path, shift, ap):
    data, preds = _golden(shift)
    ds, jds = _datasets(tmp_path, data)
    got = teval.do_coco_evaluation(ds, preds)
    want = jeval.do_coco_evaluation(jds, preds)
    for k in ("AP", "AP50", "AP75"):
        assert got[k] == want[k] == pytest.approx(ap, abs=1e-12), k
    assert got["AR"] == pytest.approx(ap, abs=1e-12)


def test_corloc_and_segm_on_coco_raise(tmp_path):
    data, preds = _case(1)
    ds, jds = _datasets(tmp_path, data)
    with pytest.raises(AttributeError, match="CLASSES"):
        jvoc.do_corloc_evaluation(jds, preds)
    with pytest.raises(ValueError, match="CLASSES"):
        tvoc.do_corloc_evaluation(ds, preds)
    with pytest.raises(KeyError, match="masks"):
        jeval.do_coco_evaluation(jds, preds, iou_types=("bbox", "segm"))
    with pytest.raises(ValueError, match="masks"):
        teval.do_coco_evaluation(ds, preds, iou_types=("bbox", "segm"))
