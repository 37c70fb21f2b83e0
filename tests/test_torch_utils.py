"""The port's utilities (odwscl_tpu_torch/utils/logging_utils.py,
miscellaneous.py, pgt_metrics.py, visualize.py) against the JAX package's
modules of the same names.

- ``SmoothedValue`` (window median, mean, global mean), ``MetricLogger``'s
  line and ``JsonlLogger``'s records equal the JAX classes' after the same
  updates (the record's wall-clock ``time`` aside when it is not passed);
  ``setup_logger`` writes ``log.txt`` on rank 0 and nothing on the others;
- ``seed_all_rng`` leaves numpy and Python in the JAX function's states;
  ``save_labels`` writes the same ``labels.json``; ``Timer``;
- ``pgt_precision_recall`` on random padded boxes within 1e-6 of the JAX
  function (f32);
- ``draw_detections`` gives the JAX function's array, pixel for pixel,
  and ``vis_results`` its files.
"""

import json
import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.utils import logging_utils as jlog
from odwscl_tpu.utils import miscellaneous as jmisc
from odwscl_tpu.utils import pgt_metrics as jpgt
from odwscl_tpu.utils import visualize as jvis
from odwscl_tpu_torch.utils import logging_utils as tlog
from odwscl_tpu_torch.utils import miscellaneous as tmisc
from odwscl_tpu_torch.utils import pgt_metrics as tpgt
from odwscl_tpu_torch.utils import visualize as tvis

UPDATES = [dict(loss=float(v), lr=0.01 * i, n=i)
           for i, v in enumerate(np.random.RandomState(0).rand(45))]


def test_smoothed_values_and_metric_logger_match():
    a, b = tlog.MetricLogger(), jlog.MetricLogger()
    for u in UPDATES:
        a.update(**u)
        b.update(**u)
        assert str(a) == str(b)
    for k in UPDATES[0]:
        ma, mb = getattr(a, k), getattr(b, k)
        assert (ma.median, ma.avg, ma.global_avg, ma.count) == \
            (mb.median, mb.avg, mb.global_avg, mb.count)
    assert a.loss.median == sorted([u["loss"] for u in UPDATES[-20:]])[10]
    with pytest.raises(AttributeError):
        a.missing
    v = tlog.SmoothedValue(4)
    assert v.median == 0.0
    for x in (5, 1, 4, 2, 3):
        v.update(x)
    assert (v.median, v.avg, v.global_avg) == (3, 2.5, 3.0)


def test_jsonl_records_match(tmp_path):
    a = tlog.JsonlLogger(str(tmp_path / "port"), start_iter=7)
    b = jlog.JsonlLogger(str(tmp_path / "jax"), start_iter=7)
    for u in UPDATES[:5]:
        a.update(time=0.25, data=0.01, **u)
        b.update(time=0.25, data=0.01, **u)
    a.update(**UPDATES[5])
    b.update(**UPDATES[5])
    got = [json.loads(line) for line in open(a.path)]
    want = [json.loads(line) for line in open(b.path)]
    assert [r["iteration"] for r in got] == list(range(8, 14))
    assert got[:5] == want[:5]
    assert set(got[5]) == set(want[5])
    assert {k: v for k, v in got[5].items() if k != "time"} == \
        {k: v for k, v in want[5].items() if k != "time"}
    assert str(a) == str(b)


def test_setup_logger_writes_on_rank_zero_only(tmp_path):
    log = tlog.setup_logger("odwscl_tpu_torch.test_utils",
                            str(tmp_path / "r0"), 0)
    log.info("hello from rank 0")
    for h in log.handlers:
        h.flush()
    assert "hello from rank 0" in (tmp_path / "r0" / "log.txt").read_text()
    # a second call moves the file to the new directory
    log = tlog.setup_logger("odwscl_tpu_torch.test_utils",
                            str(tmp_path / "again"), 0)
    log.info("second")
    assert "second" in (tmp_path / "again" / "log.txt").read_text()
    assert "second" not in (tmp_path / "r0" / "log.txt").read_text()
    log = tlog.setup_logger("odwscl_tpu_torch.test_utils",
                            str(tmp_path / "r1"), 1)
    log.info("hello from rank 1")
    assert not (tmp_path / "r1").exists()
    assert not log.handlers and log.level == logging.DEBUG


def test_seed_save_labels_timer(tmp_path):
    assert tmisc.seed_all_rng(123) == 123
    got = (np.random.rand(3), random.random())
    jmisc.seed_all_rng(123)
    np.testing.assert_array_equal(got[0], np.random.rand(3))
    assert got[1] == random.random()
    assert tmisc.seed_all_rng(-1) >= 0

    class DS:
        categories = {3: "cat", 1: "person"}

    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    tmisc.save_labels([DS(), object()], str(tmp_path / "p"))
    jmisc.save_labels([DS(), object()], str(tmp_path / "j"))
    assert (tmp_path / "p" / "labels.json").read_text() == \
        (tmp_path / "j" / "labels.json").read_text()
    tmisc.save_labels(object(), str(tmp_path))
    assert not (tmp_path / "labels.json").exists()
    t = tmisc.Timer()
    assert t.average_time == 0.0
    t.tic()
    assert t.toc(average=False) >= 0 and t.calls == 1
    t.reset()
    assert t.calls == 0


def _padded(rng, b, n, lo=0, frac=0.7):
    xy = rng.uniform(0, 60, (b, n, 2))
    wh = rng.uniform(4, 40, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < frac
    mask[lo] = False
    return boxes, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pgt_precision_recall_matches(seed):
    rng = np.random.RandomState(seed)
    pgt, pmask = _padded(rng, 5, 12)
    gt, gmask = _padded(rng, 5, 6, lo=1)
    gt[2, :3] = pgt[2, :3] + 1.0          # near matches
    got = tpgt.pgt_precision_recall(*(torch.from_numpy(a) for a in
                                      (pgt, pmask, gt, gmask)))
    want = jpgt.pgt_precision_recall(*(jnp.asarray(a) for a in
                                       (pgt, pmask, gt, gmask)))
    assert set(got) == set(want)
    assert any(float(v) > 0 for v in got.values())
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_draw_detections_and_vis_results_match(tmp_path):
    rng = np.random.RandomState(3)
    image = rng.randint(0, 255, (90, 120, 3)).astype(np.uint8)
    dets = {"boxes": rng.uniform(0, 80, (7, 4)).astype(np.float32),
            "scores": rng.uniform(size=7).astype(np.float32),
            "labels": rng.randint(0, 12, 7)}
    dets["boxes"][:, 2:] += dets["boxes"][:, :2]
    names = [f"c{i}" for i in range(12)]
    for kw in ({}, {"class_names": names, "score_thresh": 0.1}):
        got = tvis.draw_detections(image, dets, **kw)
        np.testing.assert_array_equal(got, jvis.draw_detections(image, dets,
                                                                **kw))
        assert not np.array_equal(got, image)
    p = tvis.vis_results([dets, dets], [image, image], str(tmp_path / "p"))
    j = jvis.vis_results([dets, dets], [image, image], str(tmp_path / "j"))
    assert [x.rsplit("/", 1)[1] for x in p] == \
        [x.rsplit("/", 1)[1] for x in j] == ["vis_000000.jpg",
                                             "vis_000001.jpg"]
    for a, b in zip(p, j):
        assert open(a, "rb").read() == open(b, "rb").read()
