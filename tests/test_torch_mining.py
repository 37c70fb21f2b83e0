"""The port's contrastive mining against the JAX package's, on the CPU.

``stage_a``, ``stage_b`` and ``assemble_bank`` of odwscl_tpu_torch/losses/
mining.py against odwscl_tpu/losses/mining.py on identical boxes, scores
and embeddings. Images carry several positive classes, so stage B's
boolean chain compares rows of other classes.

The embeddings are multiples of 1/4 in [-1, 1] over 8 dimensions: every
dot product and every bank sum is then exact in f32 whatever the
summation order, so the similarity thresholds and the chain decide
identically in both frameworks. (With real, normalized embeddings the
chain compares 1.0 against a self-similarity |z|^2 that rounds to either
side of 1 with the summation order.)

Bounds: the integer results (masks, slots, overflow, pgt_instance, bank
labels and validity) exact; the hardness weights and bank embeddings
1e-6.
"""

import numpy as np
import pytest
import torch

from odwscl_tpu.losses import mining as jm
from odwscl_tpu_torch.losses import mining as tm

T = torch.from_numpy


def _inputs(seed, b=2, p=40, c=6, r=3, d=8):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 80, (b, p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 50, (b, p, 2))],
                           -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.15
    mask[:, 0] = True
    labels_fg = np.zeros((b, c - 1), bool)
    labels_fg[0, [0, 2, 3]] = True
    labels_fg[1, [1, 4]] = True
    final = rng.uniform(size=(b, p, c)).astype(np.float32) * 0.1
    refs = rng.dirichlet(np.ones(c), size=(r, b, p)).astype(np.float32)
    z = (rng.randint(-4, 5, (b, p, d)) / 4.0).astype(np.float32)
    return boxes, mask, labels_fg, final, refs, z


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed,cap_a,cap_b", [(0, 128, 64), (1, 16, 8)])
def test_mining_matches_jax(seed, cap_a, cap_b):
    boxes, mask, labels_fg, final, refs, z = _inputs(seed)
    ja = jm.stage_a(boxes, mask, labels_fg, final, refs, 0.5, cap_a)
    ta = tm.stage_a(T(boxes), T(mask), T(labels_fg), T(final), T(refs), 0.5,
                    cap_a)
    for name in ("a_mask", "max_idx", "slot_b", "slot_c", "slot_p",
                 "slot_valid", "overflow"):
        _eq(getattr(ta, name), getattr(ja, name))
    np.testing.assert_allclose(ta.hardness.numpy(), ja.hardness, atol=1e-6)
    assert int(ja.slot_valid.sum()) > 4

    rng = np.random.RandomState(seed + 10)
    z_drop = (rng.randint(-4, 5, (cap_a, 8)) / 4.0).astype(np.float32)
    z_noise = (rng.randint(-4, 5, (cap_a, 8)) / 4.0).astype(np.float32)
    jb = jm.stage_b(boxes, mask, labels_fg, final, refs, z, z_drop, z_noise,
                    ja, 0.1, cap_b)
    tb = tm.stage_b(T(boxes), T(mask), T(labels_fg), T(final), T(refs),
                    T(z), T(z_drop), T(z_noise), ta, 0.1, cap_b)
    for name in ("pgt_instance", "sb_mask", "slot_b", "slot_c", "slot_p",
                 "slot_r", "slot_valid", "overflow"):
        _eq(getattr(tb, name), getattr(jb, name))
    assert int(jb.pgt_instance.sum()) > 0
    if cap_a == 16:
        assert int(ja.overflow) > 0 and int(jb.overflow) > 0

    jbank = jm.assemble_bank(ja, jb, z, z_drop, z_noise)
    tbank = tm.assemble_bank(ta, tb, T(z), T(z_drop), T(z_noise))
    for k, (got, want) in enumerate(zip(tbank, jbank)):
        if k in (0, 2):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        else:
            _eq(got, want)


def test_chain_decides_on_other_classes():
    """The boolean chain changes the cluster of some positive class in
    these inputs (else the test above would not cover it)."""
    boxes, mask, labels_fg, final, refs, z = _inputs(0)
    ta = tm.stage_a(T(boxes), T(mask), T(labels_fg), T(final), T(refs), 0.5,
                    128)
    z_bank = (np.random.RandomState(10).randint(-4, 5, (128, 8)) / 4.0
              ).astype(np.float32)
    with_chain = tm.stage_b(T(boxes), T(mask), T(labels_fg), T(final),
                            T(refs), T(z), T(z_bank), T(z_bank), ta, 0.1, 64)
    single = torch.zeros_like(T(labels_fg))
    single[0, 0] = single[1, 1] = True
    alone = tm.stage_b(T(boxes), T(mask), single, T(final), T(refs), T(z),
                       T(z_bank), T(z_bank), ta, 0.1, 64)
    assert not torch.equal(with_chain.pgt_instance[:, 0, 0],
                           alone.pgt_instance[:, 0, 0])
