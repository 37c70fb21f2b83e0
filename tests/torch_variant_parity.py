"""Shared harness of the CPU parity tests of the port's WSOD training
variants (tests/test_torch_refinement.py, test_torch_cdb.py,
test_torch_cam.py): the same flax parameters, carried over by
utils/from_jax.py, and the same numpy batch go through the JAX
``WSODDetector.apply(train=True)`` under ``jax.value_and_grad`` and through
the port's ``train_forward`` plus ``backward``.

Size as tests/test_torch_train_step.py: 6 classes, mlp_dim 64, cap_a 64,
cap_b 32, gt_cap 16, f32 compute, neck dropout 0, the real VGG16 widths,
rois within the JAX CPU pooler's exact 32 cells; the score heads scaled
(x300) so that the argmaxes of the mining and the pseudo-labels are well
apart.

The backbone is frozen whole (FREEZE_CONV_BODY_AT 5: all 13 convs, the
JAX model's ``freeze_convs`` 13): what these paths add sits above it, and
its gradients are held elsewhere (tests/test_torch_train_step.py,
test_torch_resnet.py). Under ROIPool's sparse cotangent a bin whose two
largest cells lie within the f32 drift of the two frameworks routes its
gradient to different cells, and a ReLU unit within that drift of 0 takes
opposite signs; either moves a conv gradient by up to percents. Random
VGG16 weights leave units ~1e-7 of their layer's largest magnitude from 0
on any image of this size, so tests/test_torch_resnet.py's rule (an input
whose every pre-activation keeps 1e-6 of its layer's largest from 0) cannot
be met here, and with the backbone frozen no gradient crosses it: its
forward drift reaches the pooled features as ~1e-7 relative, whichever
cell a near-tie picks.

The draws: the JAX detector's ``dropblock_2d``, ``noise_augment``, the
Concrete DropBlock's ``gumbel_softmax`` and the partial-label
``subsample_proposals`` are wrapped to use fixed keys; the port gets the
same uniforms and normals through ``draws``. ``KW`` holds the defaults;
a test's keywords override them (e.g. 81 classes); the draws follow the
pooler's resolution (``pooler_resolution``, 7 by default).

Tolerances: losses 1e-5 relative; gradients of every trainable tensor
1e-4 of its largest magnitude, at least 1e-8 absolute (the det_score bias
gets no gradient, only an f32 residue); the frozen ones none; integer
metrics equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.models.cdb as jcdb
import odwscl_tpu.models.detector as jdet
import odwscl_tpu.models.roi_sampler as jsampler
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu_torch.models import Batch, WSODDetector
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)

KW = dict(num_classes=6, mlp_dim=64, cap_a=64, cap_b=32, gt_cap=16,
          compute_dtype="float32", neck_dropout=0.0)
KEYS = {3: jax.random.PRNGKey(11), 1: jax.random.PRNGKey(12),
        "noise": jax.random.PRNGKey(13), "cdb": jax.random.PRNGKey(14),
        "subsample": jax.random.PRNGKey(15)}
HEAD_SCALE = 300.0
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_ATOL_FLOOR = 1e-8


def inputs(seed=0, b=2, h=64, w=96, p=16, c=6):
    """Images, proposals, mask and one positive class per image (stage B's
    boolean chain then compares no rows of other classes, see
    tests/test_torch_train_step.py)."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    sizes = np.array([[h, w], [h - 8, w - 16]], np.float32)[:b]
    x1y1 = rng.uniform(0, 40, (b, p, 2))
    wh = rng.uniform(8, 50, (b, p, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.2
    mask[:, 0] = True
    labels = np.zeros((b, c), np.float32)
    labels[0, 2] = labels[1 % b, 4] = 1.0
    return images, sizes, boxes, mask, labels


def jax_batch(arrays):
    """``arrays`` in the Batch's field order (None for absent fields)."""
    return JBatch(*(None if a is None else jnp.asarray(a) for a in arrays))


def port_batch(arrays):
    return Batch(*(None if a is None else torch.from_numpy(a)
                   for a in arrays))


def init_params(jkw, arrays, head_scale=HEAD_SCALE):
    """The JAX detector's init for ``jkw`` (its predictor, CDB and CAM
    leaves included), with the score heads scaled by ``head_scale``, as
    numpy f32."""
    model = jdet.WSODDetector(**{**KW, **jkw})
    v = jax.jit(lambda r, bb: model.init(r, bb, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        jax_batch(arrays))
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    for name, head in params["pred"].items():
        if not name.startswith("bbox_pred"):
            head["linear"]["kernel"] *= head_scale
    return params


def fixed_key_draws(mp):
    orig_db, orig_noise = jdet.dropblock_2d, jdet.noise_augment
    orig_gumbel = jcdb.gumbel_softmax

    def dropblock(rng, x, p, block, deterministic=False, valid=None):
        return orig_db(KEYS[block], x, p, block, deterministic, valid)

    def gumbel(rng, logits, *args, **kw):
        return orig_gumbel(KEYS["cdb"], logits, *args, **kw)

    mp.setattr(jdet, "dropblock_2d", dropblock)
    mp.setattr(jdet, "noise_augment",
               lambda rng, x: orig_noise(KEYS["noise"], x))
    mp.setattr(jcdb, "gumbel_softmax", gumbel)
    orig_subsample = jsampler.subsample_proposals
    mp.setattr(jsampler, "subsample_proposals",
               lambda rng, *a, **kw: orig_subsample(KEYS["subsample"], *a,
                                                    **kw))


def subsample_uniforms(key, b, p):
    """[B, 2, P]: the uniforms of the JAX ``subsample_proposals`` (one key
    an image, split into the positives' and the negatives' draws)."""
    return np.stack([np.stack([np.array(jax.random.uniform(r, (p,)))
                               for r in jax.random.split(k)])
                     for k in jax.random.split(key, b)])


def port_draws(n_rows, cap_a=KW["cap_a"], bp=None, r=7):
    """The uniforms and normals the wrapped JAX draws produce on an r x r
    pool; ``bp`` (B, P) adds the partial-label subsample's."""
    def arr(x):
        return torch.from_numpy(np.array(x))

    extra = ({"subsample": arr(subsample_uniforms(KEYS["subsample"], *bp))}
             if bp else {})
    return {**extra, "dropblock": arr(jax.random.uniform(KEYS[3], (n_rows, r, r))),
            "sim_drop": arr(jax.random.uniform(KEYS[1], (cap_a, r, r))),
            "noise": arr(jax.random.normal(KEYS["noise"], (cap_a, r, r, 512),
                                           jnp.float32)),
            "cdb_gumbel": arr(jax.random.uniform(KEYS["cdb"],
                                                 (n_rows, r, r, 2)))}


def jax_train(jkw, params, arrays):
    """(total, losses, metrics, grads) of the JAX train forward."""
    model = jdet.WSODDetector(**{**KW, **jkw}, freeze_convs=13)

    def loss_fn(p):
        losses, metrics = model.apply(
            {"params": p}, jax_batch(arrays), train=True,
            rngs={"dropout": jax.random.PRNGKey(3),
                  "augment": jax.random.PRNGKey(4)})
        return jnp.sum(jnp.stack(list(losses.values()))), (losses, metrics)

    with pytest.MonkeyPatch.context() as mp:
        fixed_key_draws(mp)
        (total, (losses, metrics)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return float(total), losses, metrics, grads


def port_model(params, kw):
    model = WSODDetector(**{**KW, **kw}, freeze_at=5)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def port_grads(model):
    """The port's gradients as a flax tree, zeros where none reached."""
    return leaves(jax_params_from_state_dict({
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in model.named_parameters()}))


def jax_features(kw, params, arrays):
    """The JAX detector's (frozen) backbone features of the batch's images
    [B, H', W', C], as a CPU tensor."""
    model = jdet.WSODDetector(**{**KW, **kw}, freeze_convs=13)
    feats = jax.jit(lambda v, x: model.apply(
        v, x, method=lambda m, im: m.backbone(im)))(
        {"params": params}, jnp.asarray(arrays[0]))
    return torch.from_numpy(np.array(feats))


def assert_train_matches(kw, arrays=None, params=None, same_features=False):
    """Run ``kw`` (the same constructor keywords in both packages) through
    both train forwards and hold the port to JAX; returns the port's
    (losses, metrics, model). ``same_features``: the port's train forward
    takes the JAX backbone's features (``train_forward(features=...)``),
    so that the backbone's forward drift does not reach the pool."""
    arrays = arrays if arrays is not None else inputs()
    params = params if params is not None else init_params(kw, arrays)
    want_total, want_losses, want_metrics, want_grads = jax_train(
        kw, params, arrays)
    model = port_model(params, kw)
    b, p = arrays[2].shape[:2]
    n_rows = b * min(p, kw["roi_batch_size"]) if "roi_batch_size" in kw \
        else b * p
    features = jax_features(kw, params, arrays) if same_features else None
    losses, metrics = model.train_forward(
        port_batch(arrays), features=features, draws=port_draws(
            n_rows, kw.get("cap_a", KW["cap_a"]),
            (b, p) if kw.get("partial_labels", "none") != "none" else None,
            kw.get("pooler_resolution", 7)))
    total = torch.stack(list(losses.values())).sum()
    total.backward()

    assert set(losses) == set(want_losses)
    assert set(metrics) == set(want_metrics)
    for k in metrics:
        if k.startswith(("n_", "pgt_", "bank_")):
            assert float(metrics[k]) == float(want_metrics[k]), k
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(want_losses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(total.item(), want_total, rtol=LOSS_RTOL)
    got, want = port_grads(model), leaves(want_grads)
    assert got.keys() == want.keys()
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert len(frozen) == 26 and all(p.grad is None for p in
                                     model.backbone.parameters())
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=max(GRAD_REL * scale,
                                            GRAD_ATOL_FLOOR))
    return losses, metrics, model
