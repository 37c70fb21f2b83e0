"""The TTA eval mix: the port's ``Inferencer.predict_samples`` fed by its
``EvalLoader``, with ``engine/inference.py:inference``'s one-batch-ahead
``prep_base`` prefetch on the device-resize path.

Set-up writes the configuration's synthetic test split, builds the
detector with the seed's weights and the Inferencer, and warms every
batch geometry the loader repeats (the image sizes repeat with a period of
``lcm(len(short_sides), portrait_every)`` images). The window cycles over
the split until ``--seconds`` have passed; each batch's detections are
taken to the original image's frame as ``inference`` does and kept. The
VOC mAP, computed once a dataset, stays outside. The check runs the
reference over ``check_batches`` of the window's batches drawn from the
seed and judges every detection the program gave for them.
"""

from __future__ import annotations

import concurrent.futures as futures
import itertools
import math
import time

import numpy as np

from .. import data, program
from ..reference import evaluate as ref_eval
from ..reference.model import Detector, param_shapes
from ..reference.train import load_sample
from ..trace import span


class State:
    pass


def _program(cfg, run):
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.engine.inference import Inferencer

    model = program.build_model(cfg, run.seed, run.device)
    inferencer = Inferencer(model, cfg, run.device)
    loader = make_eval_loaders(cfg, run.data_root)[0][1]
    return model, inferencer, loader


def setup(run) -> State:
    st = State()
    st.run, traffic = run, run.cell.traffic
    cfg = st.cfg = program.build_cfg(run.cell.config, traffic, run.extra)
    st.records = data.write_split(run.data_root, cfg.DATASETS.TEST[0],
                                  cfg.PROPOSAL_FILES.TEST[0],
                                  run.cell.config["dataset"], run.seed)
    st.model, st.inferencer, st.loader = _program(cfg, run)
    shape = run.cell.config["dataset"]
    period = math.lcm(len(shape["short_sides"]),
                      max(int(shape["portrait_every"]), 1))
    b = cfg.TEST.IMS_PER_BATCH
    warm = math.lcm(period, b) // b if run.warm else 0
    serve(st, itertools.islice(iter(st.loader), warm), {})
    return st


def serve(st: State, items, out: dict) -> int:
    """Predict every loader item of ``items``; keep each batch's
    detections in the original frame under its serial number in ``out``;
    returns the images served."""
    from odwscl_tpu_torch.data.transforms import get_resize_size
    from odwscl_tpu_torch.engine.inference import _lookahead
    from odwscl_tpu_torch.engine.postprocess import resize_detections

    inf = st.inferencer
    tr0 = inf.tta.transforms()[0]
    images = 0
    with futures.ThreadPoolExecutor(1) as pool:
        for _, samples, idxs, prepped in _lookahead(items, pool,
                                                    inf.prep_base):
            dets = inf.predict_samples(samples, prepped)
            kept = []
            for d, s, idx in zip(dets, samples, idxs):
                oh, ow = get_resize_size(s.size, tr0.min_size, tr0.max_size)
                kept.append((int(idx), resize_detections(d, (ow, oh),
                                                          s.size)))
            out[len(out)] = kept
            images += len(samples)
    return images


def window(st: State, seconds: float) -> dict:
    deadline = time.perf_counter() + seconds

    def feed():
        while True:
            for item in st.loader:
                if time.perf_counter() >= deadline:
                    return
                yield item

    def traced():
        it = feed()
        while True:
            with span("bench.loader_next"):
                item = next(it, None)
            if item is None:
                return
            yield item

    st.served = {}
    fin0 = st.inferencer.timings["finalize_s"]
    t0 = time.perf_counter()
    images = serve(st, traced(), st.served)
    wall = time.perf_counter() - t0
    batches = len(st.served)
    return {"kind": "eval", "batches": batches, "images": images,
            "wall_s": wall, "failed": 0,
            "finalize_s": st.inferencer.timings["finalize_s"] - fin0,
            "canvases": window_canvases(st), "model":
            program.model_shape(st.cfg), "rois": _bucket(
                st.cfg, st.run.cell.config["dataset"]["proposals"]),
            "batch": st.cfg.TEST.IMS_PER_BATCH, "itemsize": 2
            if st.cfg.TPU.COMPUTE_DTYPE == "bfloat16" else 4,
            "pooler_scale": st.cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES[0],
            "forward_rois": forward_rois(st)}


def _bucket(cfg, n: int) -> int:
    return next((k for k in sorted(cfg.TPU.PROPOSAL_BUCKETS) if n <= k),
                max(cfg.TPU.PROPOSAL_BUCKETS))


def window_canvases(st: State):
    """Each served batch's 14 forwards' canvases (h, w), in order."""
    from odwscl_tpu_torch.data.transforms import get_resize_size

    m = st.cfg.TPU.IMAGE_PAD_MULTIPLE
    out = []
    for k in sorted(st.served):
        sizes = [st.records[i].size for i, _ in st.served[k]]
        per = []
        for tr in st.inferencer.tta.transforms():
            hw = [get_resize_size(s, tr.min_size, tr.max_size)
                  for s in sizes]
            per.append(tuple(int(math.ceil(max(x) / m) * m)
                             for x in zip(*hw)))
        out.append(per)
    return out


def forward_rois(st: State):
    """[(times served, [(canvas, rois [B, P, 4], mask [B, P]) of each of
    the 14 forwards])] per distinct batch of the window: each image's
    proposals scaled to the forward's scale and, for a flip, mirrored in
    the scaled image's width, as the device-resize path makes them."""
    import collections

    import torch

    from odwscl_tpu_torch.data.transforms import get_resize_size

    m = st.cfg.TPU.IMAGE_PAD_MULTIPLE
    p = _bucket(st.cfg, st.run.cell.config["dataset"]["proposals"])
    times = collections.Counter(tuple(i for i, _ in st.served[k])
                                for k in st.served)
    out = []
    for idxs, n in times.items():
        recs = [st.records[i] for i in idxs]
        base = torch.zeros((len(recs), p, 4))
        mask = torch.zeros((len(recs), p), dtype=torch.bool)
        for j, r in enumerate(recs):
            base[j, :len(r.proposals)] = torch.from_numpy(r.proposals[:p])
            mask[j, :len(r.proposals)] = True
        forwards = []
        for tr in st.inferencer.tta.transforms():
            hw = torch.tensor([get_resize_size(r.size, tr.min_size,
                                               tr.max_size) for r in recs],
                              dtype=torch.float32)
            canvas = tuple(int(math.ceil(float(x.max()) / m) * m)
                           for x in hw.unbind(1))
            ins = torch.tensor([[r.size[1], r.size[0]] for r in recs],
                               dtype=torch.float32)
            ratio = hw / ins
            b = base * torch.stack([ratio[:, 1], ratio[:, 0], ratio[:, 1],
                                    ratio[:, 0]], -1)[:, None]
            if tr.flip:
                w = hw[:, 1:2]
                b = torch.where(mask[..., None], torch.stack(
                    [w - 1 - b[..., 2], b[..., 1], w - 1 - b[..., 0],
                     b[..., 3]], -1), b)
            forwards.append((canvas, b, mask))
        out.append((n, forwards))
    return out


def end_to_end(counts: dict) -> dict:
    return {"eval_images_per_s": counts["images"] / counts["wall_s"]}


def release(st: State) -> None:
    for name in ("model", "inferencer", "loader"):
        setattr(st, name, None)


def check_batches(st: State) -> list:
    """The served batches the check judges, drawn from the seed."""
    n = int(st.run.cell.traffic["check_batches"])
    rng = np.random.default_rng([st.run.seed, 1])
    keys = sorted(st.served)
    return [keys[i] for i in sorted(rng.choice(len(keys), min(n, len(keys)),
                                               replace=False))]


def reference_outputs(st: State, keys, precision: str = "f32") -> dict:
    """The reference's merged outputs and detections of the served batches
    ``keys``, by image index."""
    import torch

    from .. import weights as W
    from ..reference.precision import Precision

    s = program.reference_settings(st.cfg)
    params = W.make_weights(param_shapes(s["num_classes"], s["mlp_dim"],
                                         s["num_refs"], s["pooled"]),
                            st.run.seed, st.run.device)
    det = Detector(params, s, Precision(precision))
    out = {}
    with torch.no_grad():
        for k in keys:
            idxs = [i for i, _ in st.served[k]]
            samples = [load_sample(st.records[i], s["proposal_min_size"])
                       for i in idxs]
            res = ref_eval.predict(det, samples, s, st.run.device)
            for j, i in enumerate(idxs):
                out[i] = {key: res[key][j] for key in res}
    return out


def _iou(a: np.ndarray, b: np.ndarray, offset: float = 1.0) -> np.ndarray:
    """IoU of box a [4] with boxes b [N, 4]: the +1 convention of the box
    code, or with ``offset`` 0 NMS's."""
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:], b[:, 2:])
    wh = np.clip(rb - lt + offset, 0.0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda x: ((x[..., 2] - x[..., 0] + offset)
                      * (x[..., 3] - x[..., 1] + offset))
    return inter / (area(a) + area(b) - inter)


# a served detection's score is wrong when it is off the reference's
# merged score at the matching proposal by more than this share of it, and
# unmatched when by more than the second (a wrong class or box: sound runs
# stay within 2.2%, the int8 path within 7.7%)
SCORE_TOL = 0.02
GROSS_TOL = 0.1
# NMS's overlaps are read from the served boxes with this much room for
# the program's own rounding of its boxes and their IoU
IOU_ROOM = 0.02
# a reference detection is due in the served list when its score tops the
# list's last by more than this share: more than the largest gap of a
# sound run's scores, so that no near-tie at the list's end counts
DUE_MARGIN = 0.05


def gaps(served: dict, keys, ref: dict, nms: float,
         box_iou: float = 0.9) -> dict:
    """Per served detection of the batches ``keys``: ``det``, ``det_ref``,
    the least gap between its score and the reference's merged score of
    the same class at a proposal whose reference box overlaps it by
    ``box_iou`` (1 where none does), and the reference score there.

    Per image, NMS and the top-K held to their rules, which near-ties
    between overlapping boxes (the scores of overlapping proposals lie
    within rounding of each other) do not move: ``overlaps``, the served
    pairs of one class that overlap by more than NMS's threshold ``nms``
    (which NMS suppresses); ``missed``, the reference's final detections
    that score over the served list's last by ``DUE_MARGIN`` and that no
    served box of their class overlaps by more than ``nms`` (a box that
    NMS keeps either makes the list or is suppressed by one that does);
    ``count_off``, the images that got another number of detections than
    the reference's."""
    det, at = [], []
    overlaps = missed = count_off = 0
    for k in keys:
        for idx, d in served[k]:
            r = ref[idx]
            for box, score, label in zip(d["boxes"], d["scores"],
                                         d["labels"]):
                cand = r["mask"] & (_iou(box, r["boxes"][:, label]) >=
                                    box_iou)
                if cand.any():
                    diff = np.abs(r["scores"][cand, label] - score)
                    j = int(diff.argmin())
                    det.append(float(diff[j]))
                    at.append(float(r["scores"][cand, label][j]))
                else:
                    det.append(1.0)
                    at.append(0.0)
            boxes, labels = d["boxes"], d["labels"]
            for j in range(len(boxes)):
                same = np.flatnonzero(labels[j + 1:] == labels[j]) + j + 1
                overlaps += int((_iou(boxes[j], boxes[same], 0.0)
                                 > nms + IOU_ROOM).sum())
            fin = r["dets"]
            last = d["scores"].min() if len(d["scores"]) else -np.inf
            for box, score, label in zip(fin["boxes"], fin["scores"],
                                         fin["labels"]):
                if score <= last * (1.0 + DUE_MARGIN):
                    continue
                same = labels == label
                if not (_iou(box, boxes[same], 0.0) > nms - IOU_ROOM).any():
                    missed += 1
            count_off += len(d["scores"]) != len(fin["scores"])
    return {"det": det, "det_ref": at, "overlaps": overlaps,
            "missed": missed, "count_off": count_off}


def compare(served: dict, keys, ref: dict, nms: float) -> dict:
    """The numbers that decide ``correct``, over every detection served
    for the batches ``keys`` (``gaps``):

    - ``wrong_score_share``: the share whose score is off the reference's
      merged score by more than ``SCORE_TOL`` of it (the 14 forwards and
      their merge);
    - ``unmatched_detections``: how many have no proposal of the same class
      whose reference box overlaps theirs by IoU 0.9 and whose reference
      score lies within ``GROSS_TOL`` of theirs;
    - ``nms_overlaps``: the served pairs that NMS would have suppressed;
    - ``missed_detections``: the reference's detections due in the served
      lists and missing there (the top-K, and NMS suppressing too much);
    - ``count_mismatch_images``: how many images got another number of
      detections than the reference's."""
    g = gaps(served, keys, ref, nms)
    det, at = np.asarray(g["det"]), np.asarray(g["det_ref"])
    wrong = int(((det > SCORE_TOL * at) | (det >= 1.0)).sum())
    return {"wrong_score_share": wrong / max(len(det), 1),
            "unmatched_detections": int(((det >= 1.0)
                                         | (det > GROSS_TOL * at)).sum()),
            "nms_overlaps": g["overlaps"],
            "missed_detections": g["missed"],
            "count_mismatch_images": g["count_off"]}


def check(st: State) -> dict:
    keys = check_batches(st)
    return compare(st.served, keys, reference_outputs(st, keys),
                   st.cfg.MODEL.ROI_HEADS.NMS)
