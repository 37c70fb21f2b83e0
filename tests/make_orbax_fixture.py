"""Write tests/data/orbax_wsod_small/: an Orbax checkpoint of the JAX package.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py

(how the committed fixture was made; it overwrites it). Not a test module
(pytest collects ``test_*.py`` only); it imports JAX and orbax, which the
port never does. It builds the WSOD detector of
configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml (VGG16-OICR, MISTPredictor,
21 classes) at narrow widths: every VGG16 width divided by 16 (the
``VGG16-OICR`` spec in ``fixture.json``, patched into the JAX package's
``VGG_CFGS`` for this process only) and ``MLP_HEAD_DIM`` 64, f32, with the
score heads scaled by ``HEAD_SCALE`` so that the mining's argmaxes are well
apart. It takes ``STEPS`` JAX train steps (``make_train_step`` with the
config's optimizer: the momentum traces are non-zero) on a seeded batch and
saves the TrainState with the JAX package's own ``Checkpointer.save``.
Written:

- ``model_<STEPS:07d>/``: the checkpoint directory (``last_checkpoint`` is
  not kept: it names an absolute path of the machine that wrote it);
- ``expected.npz``: a seeded eval batch (``images``, ``sizes``, ``boxes``,
  ``mask``) and the JAX ``eval_forward``'s ``scores`` and ``pred_boxes``
  on it with the saved params;
- ``fixture.json``: the narrow spec, the config and its overrides, the
  step, the head scale.

The fc6 kernel (1568 x 64 f32) and its trace land in an OCDBT data file
(``ocdbt.process_0/d/``), the small arrays inline in the B-tree's leaf.
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "orbax_wsod_small")
CONFIG = "configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml"
NARROW_VGG16_OICR = [4, 4, "M", 8, 8, "M", 16, 16, 16, "M", 32, 32, 32, "I",
                     "32-D", "32-D", "32-D"]
OPTS = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "TPU.COMPUTE_DTYPE",
        "float32"]
HEAD_SCALE = 30.0
STEPS = 3


def batch_arrays(seed, b=2, h=48, w=64, p=16, classes=21):
    """Seeded images, sizes, proposals within 32 feature cells, masks and
    one positive class per image."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    sizes = np.array([[h, w], [h - 8, w - 16]][:b], np.float32)
    x1y1 = rng.uniform(0, 30, (b, p, 2))
    wh = rng.uniform(8, 30, (b, p, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.2
    mask[:, 0] = True
    labels = np.zeros((b, classes), np.float32)
    for i in range(b):
        labels[i, 1 + rng.randint(classes - 1)] = 1.0
    return images, sizes, boxes, mask, labels


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    import odwscl_tpu.models.vgg16 as jvgg
    from odwscl_tpu.config import get_default_cfg
    from odwscl_tpu.engine.trainer import create_train_state, make_train_step
    from odwscl_tpu.models import Batch, build_model
    from odwscl_tpu.utils.checkpoint import Checkpointer

    jvgg.VGG_CFGS["VGG16-OICR"] = NARROW_VGG16_OICR
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(ROOT, CONFIG))
    cfg.merge_from_list(OPTS)
    cfg.freeze()
    model = build_model(cfg)
    batch = Batch(*(jnp.asarray(a) for a in batch_arrays(0)))
    freeze_at = cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT
    freeze = jvgg.FREEZE_CONV_COUNTS[freeze_at - 1] if freeze_at > 0 else 0
    state, tx, _ = create_train_state(model, cfg, batch,
                                      jax.random.PRNGKey(cfg.SEED), freeze)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    for name, head in params["pred"].items():
        if not name.startswith("bbox_pred"):
            head["linear"]["kernel"] = head["linear"]["kernel"] * HEAD_SCALE
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    step = jax.jit(make_train_step(model, tx))
    for i in range(STEPS):
        state, logs = step(state, batch)
        bad = [k for k, v in logs.items() if not np.isfinite(float(v))]
        assert not bad, (i, bad)
        print(f"step {i + 1}: loss {float(logs['loss']):.4f}")

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    tmp = tempfile.mkdtemp()
    try:
        Checkpointer(tmp).save(STEPS, state)
        name = f"model_{STEPS:07d}"
        shutil.copytree(os.path.join(tmp, name), os.path.join(OUT, name))
    finally:
        shutil.rmtree(tmp)

    images, sizes, boxes, mask, labels = batch_arrays(1)
    ebatch = Batch(*(jnp.asarray(a) for a in (images, sizes, boxes, mask,
                                              labels)))
    scores, pred_boxes = jax.jit(lambda p, b: model.apply(
        {"params": p}, b, method="eval_forward"))(state.params, ebatch)
    np.savez(os.path.join(OUT, "expected.npz"), images=images, sizes=sizes,
             boxes=boxes, mask=mask, scores=np.asarray(scores),
             pred_boxes=np.asarray(pred_boxes))
    with open(os.path.join(OUT, "fixture.json"), "w") as f:
        json.dump({"VGG16-OICR": NARROW_VGG16_OICR, "config": CONFIG,
                   "opts": OPTS, "step": STEPS, "head_scale": HEAD_SCALE,
                   "checkpoint": name}, f, indent=1)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
