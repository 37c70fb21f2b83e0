"""Data-parallel training of the port's supervised families equals one
process (odwscl_tpu_torch/parallel/mesh.py with the FPN bodies' list of
levels gathered).

Mask R-CNN here and RetinaNet in
tests/test_torch_data_parallel_families.py
(configs/coco/coco_{mask_rcnn,retinanet}_smoke.yaml, R-18-FPN, 3 steps
of a global batch of 2, the canvas padded to 32 so that the two ranks'
images pad differently alone) on 2 ``gloo`` processes against one
process. The CPU's convolutions of the ResNet bodies give an image
results that depend on the batch it is in (~2e-6 relative; the VGG16
body's do not), enough to flip ReLUs of a random FrozenBN ResNet after
the first update: so the first step is held to the one process on the
whole batch, and every step to the one process that runs the backbone in
the ranks' two halves of the batch (``chunks``), the rest of the step on
the whole batch, on one thread as each rank does (the CPU GEMMs' sums
depend on the thread count). Every loss and metric within 1e-5
relative, the parameters within 1e-5 absolute. The proposals pad to 48.
"""

import numpy as np
import torch

from odwscl_tpu_torch.data.synthetic import write_synthetic_coco
from torch_dp_workers import run_ranks, train

OPTS = ["SOLVER.MAX_ITER", "3", "DATALOADER.NUM_WORKERS", "1",
        "TPU.IMAGE_PAD_MULTIPLE", "32", "INPUT.MIN_SIZE_TRAIN", "(64, 96)",
        "TPU.PROPOSAL_BUCKETS", "(48,)"]
RTOL = 1e-5
PARAM_ATOL = 1e-5


def check_supervised(config, tmp_path):
    """The data-parallel run of ``config`` on 2 ranks against the one
    process (see above)."""
    coco = str(tmp_path / "coco17")
    write_synthetic_coco(coco, 4, 2, seed=0, img_hw=(100, 130), n_props=40,
                         layout="coco17")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # the ranks' GEMMs run on one thread
    try:
        (whole,) = train(config, OPTS + ["SOLVER.MAX_ITER", "1"], coco,
                         [None])
        (single,) = train(config, OPTS, coco, [None], 1.0, 2)
    finally:
        torch.set_num_threads(threads)
    ((run,), _) = run_ranks(2, tmp_path, "train", config, OPTS, coco, [None])
    a, b = whole["steps"][0], run["steps"][0]
    for k in a:
        if k not in ("step_s", "data_s"):
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-9,
                                       err_msg=f"1 {k}")
    assert len(run["steps"]) == len(single["steps"]) == 3
    for a, b in zip(single["steps"], run["steps"]):
        assert set(a) == set(b)
        for k in a:
            if k not in ("step_s", "data_s"):
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-9,
                                           err_msg=f"{a['iter']} {k}")
    moved = 0
    for k, v in single["params"].items():
        np.testing.assert_allclose(run["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
        moved += not torch.equal(v, single["init"][k])
    assert moved > 0


def test_mask_rcnn_data_parallel_equals_one_process(tmp_path):
    check_supervised("configs/coco/coco_mask_rcnn_smoke.yaml", tmp_path)
