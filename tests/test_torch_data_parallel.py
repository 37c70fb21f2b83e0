"""Data-parallel training of the port (odwscl_tpu_torch/parallel/mesh.py,
data/samplers.py, data/collate.py, engine/trainer.py) equals one process
on the global batch, as tests/test_parallel.py holds the JAX mesh to one
device.

The VGG16 contrastive WSOD detector at a tiny width (21 classes,
mlp_dim 64, bank capacity 64, f32, the neck's dropout and the DropBlock
drawn from the generator) trains 3 steps of a global batch of 4 from a
synthetic VOC split through ``make_train_loader`` + ``do_train``: once in
this process, and on 2 and 4 ``gloo`` processes (each loading its share,
so the ranks' images differ in size and the global canvas is what they
pad to). Stage A fills its bank from every image of the batch (recorded).
Each image carries one class (the annotation's other objects are
relabelled): stage B's chain compares 1.0 with a self-similarity that
rounds to either side of 1 with the summation order
(tests/test_torch_train_step.py), and the data-parallel gradient sums the
ranks' parts in another order than one process's convolution does.

Checks against the one process: every loss and metric of every step
within 1e-5 relative, the ``n_*`` counters equal, the parameters within
the flip-aware envelope of tests/test_parallel.py:80-118 (and, with equal
counters, within 1e-5 absolute: reassociation only). The same envelope
must reject a run with the missing mean (each rank's gradient summed over
the ranks, not averaged).
"""

import glob
import re

import numpy as np
import pytest
import torch

from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from torch_dp_workers import run_ranks, train

CONFIG = "configs/voc/voc07_synth_smoke.yaml"
OPTS = ["INPUT.MIN_SIZE_TRAIN", "(48, 64, 80)", "INPUT.MAX_SIZE_TRAIN", "112",
        "TPU.IMAGE_PAD_MULTIPLE", "32", "TPU.PROPOSAL_BUCKETS", "(32,)",
        "SOLVER.IMS_PER_BATCH", "4", "SOLVER.MAX_ITER", "3",
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "TPU.COMPUTE_DTYPE",
        "float32", "TPU.BANK_CAPACITY", "64", "DATALOADER.NUM_WORKERS", "1"]
HEAD_SCALE = 300.0        # clear argmax margins in the mining
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
SIG = ("n_bank", "n_mined", "n_pos0", "n_pos1", "n_pos2")


def one_class_voc(root):
    """Synthetic VOC trainval of 8 images, every object of an image
    relabelled to its first object's class."""
    write_synthetic_voc(root, n_test=2, seed=0, img_hw=(120, 144),
                        n_props=32, prop_size=(10, 30), obj_size=(20, 40),
                        n_trainval=8)
    for path in glob.glob(f"{root}/voc/VOC2007/Annotations/*.xml"):
        with open(path) as f:
            xml = f.read()
        first = re.search(r"<name>(\w+)</name>", xml).group(1)
        with open(path, "w") as f:
            f.write(re.sub(r"<name>\w+</name>", f"<name>{first}</name>",
                           xml))
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return one_class_voc(str(tmp_path_factory.mktemp("voc")))


@pytest.fixture(scope="module")
def single(data):
    torch.set_num_threads(2)
    (run,) = train(CONFIG, OPTS, data, [None], HEAD_SCALE)
    return run


def drift_stats(p0, pa, pb):
    """Per leaf: |pa - pb| over the larger movement from p0, and the ratio
    of the movements (tests/test_parallel.py)."""
    drifts, ratios = {}, {}
    for k in p0:
        a0 = p0[k].double().numpy()
        a, b = pa[k].double().numpy(), pb[k].double().numpy()
        mova, movb = np.abs(a - a0).max(), np.abs(b - a0).max()
        drifts[k] = np.abs(a - b).max() / max(mova, movb, 1e-8)
        ratios[k] = (mova + 1e-12) / (movb + 1e-12)
    return drifts, ratios


def honest_envelope_ok(drifts, ratios):
    med_ratio = float(np.median(list(ratios.values())))
    med_drift = float(np.median(list(drifts.values())))
    return (1 / 1.5 <= med_ratio <= 1.5) and med_drift < 0.5


def check_equal_runs(single, run):
    """The data-parallel ``run`` against the one-process ``single``."""
    assert len(run["steps"]) == len(single["steps"]) == 3
    for a, b in zip(single["steps"], run["steps"]):
        assert set(a) == set(b)
        for k in a:
            if k in ("step_s", "data_s", "iter"):
                continue
            if k.startswith("n_") or "overflow" in k:
                assert a[k] == b[k], (a["iter"], k, a[k], b[k])
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL,
                                           atol=1e-9,
                                           err_msg=f"{a['iter']} {k}")
    drifts, ratios = drift_stats(single["init"], single["params"],
                                 run["params"])
    diag = sorted(drifts.items(), key=lambda kv: -kv[1])[:5]
    assert honest_envelope_ok(drifts, ratios), diag
    assert max(drifts.values()) < 1.5, diag
    sig = [[s[k] for k in SIG] for s in single["steps"]]
    if sig == [[s[k] for k in SIG] for s in run["steps"]]:
        assert np.median(list(drifts.values())) < 0.1, diag
        assert max(drifts.values()) < 0.75, diag
        for k, v in single["params"].items():
            np.testing.assert_allclose(run["params"][k].numpy(), v.numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_the_one_process_run_mines_across_images(single):
    assert all(s["n_bank"] > 0 and s["n_mined"] > 0
               for s in single["steps"])
    # stage A's bank holds rois of several images in every step
    assert all(len(images) > 1 for images in single["bank_images"])


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_equals_one_process(data, single, tmp_path, world):
    jobs = [None, "sum"] if world == 2 else [None]
    ranks = run_ranks(world, tmp_path, "train", CONFIG, OPTS, data, jobs,
                      HEAD_SCALE)
    honest = ranks[0][0]
    # every rank logged the same global step
    for r in ranks[1:]:
        assert [s["loss"] for s in r[0]["steps"]] == \
            [s["loss"] for s in honest["steps"]]
    assert honest["bank_images"] == single["bank_images"]
    check_equal_runs(single, honest)
    if world == 2:
        faulty = ranks[0][1]
        drifts, ratios = drift_stats(single["init"], single["params"],
                                     faulty["params"])
        assert not honest_envelope_ok(drifts, ratios), (
            "the missing mean was not detected",
            float(np.median(list(ratios.values()))))
