"""The port imports neither JAX nor the JAX package.

Every module of ``odwscl_tpu_torch`` (the training, ResNet, weight-import,
device-resize, Concrete DropBlock, CAM, int8 serving, COCO, web data and
partial-label modules named below among them)
and ``chip_smoke.py``
is imported in a subprocess where ``jax``, ``flax``, ``optax``,
``odwscl_tpu``, ``cv2``, ``triton``, ``orbax``, ``tensorstore``,
``zstandard`` and ``zarr`` are blocked
(``sys.modules[name] = None`` makes their import fail); afterwards no
``jax*`` or ``odwscl_tpu.*`` module may be loaded. The supervised
families' modules (FPN, RetinaNet, the supervised R-CNN, its heads, the
mask structures, roi_align and the Fast R-CNN loss) are among those
named, and so are the keypoint structures and head, the FBNet bodies,
the deformable-conv ops, the data-, tensor- and spatially-parallel
modules, the loggers and the other utilities, the native host library's
binding and the proposal converter, and the Orbax import's zstd decoder,
OCDBT reader and zarr reader, which must need none of the libraries that
wrote the checkpoints, and the int8 accuracy study. No tolerance applies.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "odwscl_tpu", "cv2",
             "triton", "orbax", "tensorstore", "zstandard", "zarr"):
    sys.modules[name] = None
import odwscl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(odwscl_tpu_torch.__path__,
                                               "odwscl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "odwscl_tpu",
                        "orbax", "tensorstore", "zstandard", "zarr")))
print(len(names), "modules", bad)
assert not bad, bad
for required in ("ops.dropblock", "losses.mining", "losses.supcon",
                 "losses.pseudo_labels", "solver.build", "engine.trainer",
                 "utils.checkpoint", "tools.train_net", "tools.profile_train",
                 "ops.roi_pool_stages", "tools.profile_pool_stages",
                 "models.resnet", "utils.weight_import", "ops.device_resize",
                 "models.cdb", "models.cam", "models.cam_proposals",
                 "ops.quant", "utils.dist", "data.coco_dataset",
                 "data.flickr", "evaluation.coco_eval", "structures.rle",
                 "models.matcher", "models.roi_sampler",
                 "losses.partial_labels", "models.fpn", "models.retinanet",
                 "models.supervised", "models.roi_heads", "models.mask_head",
                 "structures.masks", "ops.roi_align", "losses.fast_rcnn",
                 "structures.keypoints", "models.keypoint_head",
                 "models.fbnet", "ops.deform_conv", "parallel.mesh",
                 "parallel.tp", "parallel.sp", "utils.logging_utils",
                 "utils.miscellaneous", "utils.pgt_metrics",
                 "utils.visualize", "utils.host_ops",
                 "tools.proposal_convert", "utils.zstd", "utils.ocdbt",
                 "utils.orbax_import", "tools.int8_accuracy_study"):
    assert "odwscl_tpu_torch." + required in names, required
assert len(names) >= 90, names
"""


def test_port_imports_without_jax():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("[]"), proc.stdout
