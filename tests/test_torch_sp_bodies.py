"""The port's spatially-parallel ResNet, FPN and FBNet bodies
(odwscl_tpu_torch/parallel/sp.py) against the JAX package's
(odwscl_tpu/parallel/sp.py:sp_backbone_apply) and the unsharded bodies.

Bodies: R-18-C5 (stride-16 C5), R-18-C4, R-18-FPN (P2-P6), R-18-FPN P3-P7
(RetinaNet's, P6 / P7 on C5), FBNet "default" and an FBNet arch def with
squeeze-excite blocks, a depthwise k5 and a negative stride (a nearest
upsample). Each has one random flax init (its FrozenBN leaves randomized)
carried over by utils/from_jax.py and one batch (B = 2, W = 64, unit
normals), and runs on sp = 2 and 4 ``gloo`` processes (every case of one
world size in one spawn) at H = 256 and, at sp = 4, H = 200 (not a
multiple of the deepest stride 32 x 4: the last band is 8 rows) and on
the JAX function's (8 // sp, sp) meshes of the 8 virtual CPU devices.

Bounds, f32: every level of every rank within atol 5e-5, rtol 1e-5 of
JAX's ``sp_backbone_apply`` (JAX's own bands part from its unsharded
apply by up to 1.5e-5), and within 1e-5 of the level's largest magnitude
of the unsharded port body. A hook on ``torch.nn.functional.conv2d`` shows
that each rank's stem input is its band plus the halo rows only (the 7x7
stride-2 stem: 3 rows above, 2 below; FBNet's 3x3 stride-2 first conv: 1
above, none below; a neighbour's rows, or padding at the image's
edges), ``gather=False`` leaves each rank its band of each banded level
(the FPN's top block whole), ``sp_stitch`` (the same band
arithmetic in one process, one thread a band) equals the unsharded body at
world 1 bit for bit and within the same bound at 4, and too thin or empty
bands raise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.models import fbnet as jfbnet
from odwscl_tpu.models import fpn as jfpn
from odwscl_tpu.models import resnet as jresnet
from odwscl_tpu.parallel import make_sp_mesh, sp_backbone_apply
from odwscl_tpu_torch.models import fbnet, fpn, resnet
from odwscl_tpu_torch.parallel.sp import (Bands, deepest_stride, sp_bands,
                                          sp_stitch, window_plan)
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax
from torch_dp_workers import join_ranks, start_ranks

JAX_ATOL, JAX_RTOL = 5e-5, 1e-5
REL = 1e-5
B, W = 2, 64
# (h, sp) of each body's runs
RUNS = ((256, 2), (256, 4), (200, 4))

ARCH = json.dumps({
    "block_op_type": [["ir_k3_se", "ir_k5_e3"], ["ir_k3", "ir_k3_se"],
                      ["ir_k3_e2_s4"]],
    "block_cfg": {"first": [16, 2],
                  "stages": [[[1, 16, 1, 1], [3, 24, 1, 2]],
                             [[4, 32, 1, 2], [3, 32, 1, -2]],
                             [[2, 48, 1, 2]]],
                  "backbone": [0, 1, 2]}})

# name -> (JAX module, port kind, port kwargs, stem rows (above, below))
BODIES = {
    "R-18-C5": (jresnet.ResNetBackbone("R-18", 5, compute_dtype=jnp.float32),
                "ResNetBackbone", {"depth": "R-18", "stages_out": 5}, (3, 2)),
    "R-18-C4": (jresnet.ResNetBackbone("R-18", 4, compute_dtype=jnp.float32),
                "ResNetBackbone", {"depth": "R-18", "stages_out": 4}, (3, 2)),
    "R-18-FPN": (jfpn.ResNetFPNBackbone("R-18", compute_dtype=jnp.float32),
                 "ResNetFPNBackbone", {"depth": "R-18"}, (3, 2)),
    "R-18-FPN-P3P7": (
        jfpn.ResNetFPNP3P7Backbone("R-18", compute_dtype=jnp.float32),
        "ResNetFPNP3P7Backbone", {"depth": "R-18"}, (3, 2)),
    "FBNet-default": (jfbnet.FBNetTrunk(compute_dtype=jnp.float32),
                      "FBNetTrunk", {}, (1, 0)),
    "FBNet-se-upsample": (
        jfbnet.FBNetTrunk(arch_def=ARCH, compute_dtype=jnp.float32),
        "FBNetTrunk", {"arch_def": ARCH}, (1, 0)),
}
KINDS = {"ResNetBackbone": resnet.ResNetBackbone,
         "ResNetFPNBackbone": fpn.ResNetFPNBackbone,
         "ResNetFPNP3P7Backbone": fpn.ResNetFPNP3P7Backbone,
         "FBNetTrunk": fbnet.FBNetTrunk}


def _randomize_bn(tree, rng):
    for v in tree.values():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            c = v["scale"].shape
            v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            v["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            v["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            v["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif isinstance(v, dict):
            _randomize_bn(v, rng)
    return tree


def body_bands(h, stride, world):
    """The padded bodies' bands: ceil(h / stride) rows at the stride."""
    return Bands(h, tuple(sp_bands(h, stride, world, -(-h // stride))))


def _images(h, seed):
    return np.random.RandomState(seed).randn(B, h, W, 3).astype(np.float32)


@pytest.fixture(scope="module")
def setups():
    """name -> (flax params, the port state_dict as numpy)."""
    out = {}
    for i, (name, (jm, _, _, _)) in enumerate(BODIES.items()):
        params = jax.jit(jm.init)(jax.random.PRNGKey(i),
                                  jnp.asarray(_images(64, 0)))["params"]
        params = _randomize_bn(jax.tree_util.tree_map(
            lambda a: np.array(a, np.float32), params),
            np.random.RandomState(i))
        sd = state_dict_from_jax({"backbone": params})
        out[name] = (params, {k[len("backbone."):]: v.numpy()
                              for k, v in sd.items()})
    return out


def _port(name, state):
    _, kind, kw, _ = BODIES[name]
    bb = KINDS[kind](**kw, compute_dtype=torch.float32)
    bb.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return bb


def _levels(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def ranks(setups, tmp_path_factory):
    """Every body's runs on each world size (one spawn a world size, both
    at once) and, while they run, the JAX function's: {"jax": {(name, h,
    sp): levels}, sp: {(name, h, gather): [(levels, stem rows) of rank
    r]}}."""
    started, states = {}, tmp_path_factory.mktemp("states")
    for name in BODIES:           # a file each, not pickled to every rank
        np.savez(states / f"{name}.npz", **setups[name][1])
    for sp in (2, 4):
        keys, cases = [], []
        for name, (_, kind, kw, _) in BODIES.items():
            state = str(states / f"{name}.npz")
            for h, s in RUNS:
                if s == sp:
                    keys.append((name, h, True))
                    cases.append((kind, kw, state, _images(h, 1), True))
            if sp == 4:
                keys.append((name, 200, False))
                cases.append((kind, kw, state, _images(200, 1), False))
        started[sp] = keys, start_ranks(
            sp, tmp_path_factory.mktemp(f"sp{sp}"), "sp_bodies", cases)
    out = {"jax": {(name, h, sp): _levels(sp_backbone_apply(
        make_sp_mesh(8 // sp, sp), {"params": setups[name][0]},
        jnp.asarray(_images(h, 1)), jm))
        for name, (jm, _, _, _) in BODIES.items() for h, sp in RUNS}}
    for sp, (keys, handle) in started.items():
        res = join_ranks(handle)
        out[sp] = {k: [r[i] for r in res] for i, k in enumerate(keys)}
    return out


@pytest.mark.parametrize("name", list(BODIES))
def test_sp_body_matches_jax_and_unsharded(name, setups, ranks):
    _, _, _, (above, below) = BODIES[name]
    bb = _port(name, setups[name][1])
    stride = deepest_stride(bb)
    for h, sp in RUNS:
        x = _images(h, 1)
        want_jax = ranks["jax"][(name, h, sp)]
        with torch.no_grad():
            want = [w.numpy() for w in _levels_t(bb(torch.from_numpy(x)))]
        assert [w.shape for w in want] == [w.shape for w in want_jax]
        bands = body_bands(h, stride, sp)
        for r, (got, rows) in enumerate(ranks[sp][(name, h, True)]):
            assert [g.shape for g in got] == [w.shape for w in want]
            for lvl, (g, w, wj) in enumerate(zip(got, want, want_jax)):
                np.testing.assert_allclose(
                    g, wj, rtol=JAX_RTOL, atol=JAX_ATOL,
                    err_msg=f"{name} h {h} sp {sp} rank {r} level {lvl}")
                err = np.abs(g - w).max() / np.abs(w).max()
                assert err <= REL, (name, h, sp, r, lvl, err)
            # the stem's input: the band and its halo rows only (the
            # neighbours' rows, or the padding at the image's edges)
            lo, hi = bands.bounds[r]
            assert rows == hi - lo + above + below, (r, rows)


def _levels_t(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(BODIES))
def test_gather_false_keeps_the_bands(name, setups, ranks):
    bb = _port(name, setups[name][1])
    x = _images(200, 1)
    with torch.no_grad():
        want = [w.numpy() for w in _levels_t(bb(torch.from_numpy(x)))]
    bands = body_bands(200, deepest_stride(bb), 4)
    banded = {"R-18-FPN": 4, "R-18-FPN-P3P7": 3}.get(name, 1)
    outs = [got for got, _ in ranks[4][(name, 200, False)]]
    for lvl, w in enumerate(want):
        parts = [got[lvl] for got in outs]
        if lvl >= banded:          # the FPN's top block: whole everywhere
            got = parts
        else:
            # rank r's rows of a stride-s level start at its band's first
            # row / s; the last band runs to the level's bottom
            s = next(s for s in (4, 8, 16, 32) if -(-200 // s) == w.shape[1])
            firsts = np.cumsum([0] + [p.shape[1] for p in parts[:-1]])
            assert firsts.tolist() == [lo // s for lo, _ in bands.bounds]
            got = [np.concatenate(parts, 1)]
        for g in got:
            assert g.shape == w.shape, (lvl, g.shape, w.shape)
            assert np.abs(g - w).max() <= REL * np.abs(w).max(), lvl


@pytest.mark.parametrize("name", ["R-18-FPN", "FBNet-se-upsample"])
def test_stitched_bands(name, setups):
    bb = _port(name, setups[name][1])
    x = torch.from_numpy(_images(200, 2))
    with torch.no_grad():
        want = _levels_t(bb(x))
        one, = sp_stitch(bb, x, 1)
        assert all(torch.equal(a, b) for a, b in zip(_levels_t(one), want))
        for got in sp_stitch(bb, x, 4):
            for g, w in zip(_levels_t(got), want):
                assert g.shape == w.shape
                assert (g - w).abs().max() <= REL * w.abs().max()


def test_bands_and_refusals():
    assert body_bands(256, 32, 4).bounds == ((0, 64), (64, 128), (128, 192),
                                             (192, 256))
    assert body_bands(200, 32, 4).bounds == ((0, 64), (64, 128), (128, 192),
                                             (192, 200))
    assert body_bands(200, 16, 2).bounds == ((0, 112), (112, 200))
    with pytest.raises(ValueError, match="empty"):
        body_bands(64, 32, 4)                 # 2 rows at stride 32
    # the stem's 7x7 stride 2 on the 200-row split: 3 rows up, 2 down
    plan = window_plan(body_bands(200, 32, 4), 7, 2, 3)
    assert plan.need == ((-3, 66), (61, 130), (125, 194), (189, 202))
    assert plan.out.bounds == ((0, 32), (32, 64), (64, 96), (96, 100))
    assert [plan.recv(r) for r in range(4)] == [(0, 2), (3, 2), (3, 2),
                                                (3, 0)]
    assert [plan.send(r) for r in range(4)] == [(0, 3), (2, 3), (2, 3),
                                                (2, 0)]
    # a 5x5 (FBNet's k5) on 1-row bands needs 2 rows of each neighbour
    with pytest.raises(ValueError, match="thinner than the 2-row halo"):
        window_plan(_rows_of(4, 1), 5, 1, 2)
    with pytest.raises(ValueError, match="stride"):
        window_plan(_rows_of(2, 3), 3, 2, 1)   # bands start at row 3
    # a k5 depthwise at stride 8: 1-row bands at H = 32, 2-row at 64
    k5 = fbnet.FBNetTrunk(arch_def=json.dumps({
        "block_op_type": [["ir_k3"], ["ir_k3", "ir_k5"]],
        "block_cfg": {"first": [8, 2],
                      "stages": [[[1, 8, 1, 2]], [[1, 8, 1, 2],
                                                  [1, 8, 1, 1]]],
                      "backbone": [0, 1]}}), compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="1 rows .* 2-row halo"):
        sp_stitch(k5, torch.zeros(1, 32, 16, 3), 4)
    assert [o.shape[1] for o in sp_stitch(k5, torch.zeros(1, 64, 16, 3),
                                          4)] == [8] * 4


def _rows_of(world, n):
    return Bands(world * n, tuple((r * n, (r + 1) * n)
                                  for r in range(world)))
