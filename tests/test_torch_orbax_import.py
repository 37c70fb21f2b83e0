"""The port's Orbax import against orbax's restore and the JAX package's
step, on the CPU.

``odwscl_tpu_torch/utils/orbax_import.py:load_orbax`` reads a checkpoint
directory without orbax, tensorstore or a zstd library. Every leaf must
equal ``orbax.checkpoint.StandardCheckpointer().restore``'s bit for bit
(dtype, shape, bytes; bfloat16 as its uint16 bits) on trees that the JAX
package's ``Checkpointer.save`` writes:
- the WSOD TrainState of configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml at
  narrow widths (every VGG16 width / 16, MLP 64), with the Concrete
  DropBlock off and on (its labels then hold ``optax.chain`` states);
- the R-18-FPN Mask R-CNN TrainState of
  configs/coco/coco_mask_rcnn_smoke.yaml;
each with random params and momentum traces of the model's shapes (from
``jax.eval_shape`` of its init: nothing is compiled). And on
``StandardCheckpointer.save`` of sharded ``jax.Array`` leaves (an f32 leaf
over 8 chunks, a bfloat16 leaf over 4 x 2), an ``<i4`` and a Python float
scalar; on zarr arrays that tensorstore writes with chunks that do not
divide the shape (edge chunks cropped); on tests/data/orbax_wsod_small,
the committed fixture of tests/make_orbax_fixture.py (3 JAX train steps),
also through the pure-Python zstd decoder.

Through the port, on the fixture: the imported model's ``eval_forward``
equals the same params loaded through an ``.npz`` exactly and the JAX
``eval_forward`` (``expected.npz``) within tests/test_torch_detector.py's
bounds (scores 5e-5, boxes 1e-4 px); the resumed step (``Checkpointer.
load`` into the model and ``make_optimizer``'s optimizer, then
``train_step``) matches the JAX package's next step from the same saved
state with the draws handed over as tests/torch_variant_parity.py does:
the loaded momentum buffers equal the saved traces exactly, the integer
metrics equal, the losses within 1e-4 relative, the new traces within the
gradient bounds of tests/test_torch_train_step.py (1e-4 of each tensor's
largest magnitude; conv4-conv9 3e-2), the parameters within 1e-5.

What the reader does not handle raises ``ValueError`` naming the key: a
leaf that is not an array, another compressor, filters, Fortran order,
zarr v3, a missing chunk, ``use_zarr3``, a store that is not OCDBT; the
JAX ``rng`` is not carried over (the generator is left as seeded);
``optimizer_state_from_jax``
raises on ``optax.MultiSteps`` state (SOLVER.ITER_SIZE > 1, not imported)
and on a checkpoint whose frozen convs differ from the optimizer's.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import odwscl_tpu.models.detector as jdet
import odwscl_tpu.models.vgg16 as jvgg
import odwscl_tpu_torch.models.vgg16 as tvgg
from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.engine.trainer import TrainState, make_train_step
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.models import build_model as jax_build_model
from odwscl_tpu.solver import make_optimizer as jax_make_optimizer
from odwscl_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.engine.trainer import train_step
from odwscl_tpu_torch.models import Batch, WSODDetector, build_model
from odwscl_tpu_torch.solver import make_optimizer
from odwscl_tpu_torch.utils import orbax_import, zstd
from odwscl_tpu_torch.utils.checkpoint import Checkpointer, load_model_weights
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             optimizer_state_from_jax,
                                             save_npz, state_dict_from_jax)
from odwscl_tpu_torch.utils.ocdbt import OcdbtStore
from torch_variant_parity import KEYS, fixed_key_draws, leaves

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_wsod_small")
with open(os.path.join(FIXTURE, "fixture.json")) as _f:
    FX = json.load(_f)
FIXTURE_CKPT = os.path.join(FIXTURE, FX["checkpoint"])
SCORE_ATOL, BOX_ATOL = 5e-5, 1e-4
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
GRAD_REL, GRAD_REL_BELOW_CONV10 = 1e-4, 3e-2
GRAD_ATOL_FLOOR = 1e-8
INT_METRICS = ("n_bank", "n_mined", "bank_overflow", "n_pos0", "n_pos1",
               "n_pos2", "pgt_overflow0", "pgt_overflow1", "pgt_overflow2")
# the fixture's model as the parity tests build it (the tree is the one
# the config builds; cap sizes, dropout and dtype do not change it)
KW = dict(num_classes=21, mlp_dim=64, cap_a=64, cap_b=32, gt_cap=16,
          compute_dtype="float32", neck_dropout=0.0)


@pytest.fixture(scope="module")
def narrow():
    """The fixture's VGG16-OICR widths in both packages' VGG_CFGS."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvgg.VGG_CFGS, "VGG16-OICR", FX["VGG16-OICR"])
        mp.setitem(tvgg.VGG_CFGS, "VGG16-OICR", FX["VGG16-OICR"])
        yield


def _restore(path):
    return ocp.StandardCheckpointer().restore(path)


def _bits(v):
    if isinstance(v, torch.Tensor):
        assert v.dtype == torch.bfloat16
        return "bfloat16", tuple(v.shape), v.view(torch.int16).numpy().tobytes()
    a = np.asarray(v)
    if a.dtype == jnp.bfloat16:
        return "bfloat16", a.shape, a.view(np.int16).tobytes()
    return str(a.dtype), a.shape, a.tobytes()


def _assert_same_leaves(got, want):
    """Every leaf of orbax's restore ``want`` is in ``got`` bit for bit, and
    ``got`` holds no other array."""
    def get(tree, path):
        for k in path:
            key = getattr(k, "key", getattr(k, "idx", None))
            tree = tree[int(key)] if isinstance(tree, list) else tree[key]
        return tree

    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    for path, v in want_leaves:
        assert _bits(get(got, path)) == _bits(v), jax.tree_util.keystr(path)
    n_got = len([x for x in jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
        if isinstance(x, (np.ndarray, torch.Tensor, int, float))])
    assert n_got == len(want_leaves)


def _random_state(model, cfg, batch, freeze, seed):
    """A TrainState of ``model``'s shapes with random params and momentum
    traces (``jax.eval_shape`` of the init: nothing compiled)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        batch, method="init_all"))["params"]
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(s.dtype), shapes)
    cdb = cfg.SOLVER_CDB if cfg.DB.METHOD == "concrete" else None
    tx, _ = jax_make_optimizer(cfg.SOLVER, params, freeze, cdb,
                               cfg.DB.WEIGHT)
    opt_state = jax.tree_util.tree_map(
        lambda x: (np.full(x.shape, 5, x.dtype)
                   if jnp.issubdtype(x.dtype, jnp.integer)
                   else rng.randn(*x.shape).astype(x.dtype)),
        tx.init(params))
    return TrainState(step=np.int32(5), params=params, opt_state=opt_state,
                      rng=np.asarray(jax.random.PRNGKey(seed)))


def _wsod_cfg(*opts):
    cfg = jax_cfg()
    cfg.merge_from_file(os.path.join(ROOT, FX["config"]))
    cfg.merge_from_list([*FX["opts"], *opts])
    return cfg


def _wsod_batch(p=16):
    from make_orbax_fixture import batch_arrays
    images, sizes, boxes, mask, labels = batch_arrays(0, p=p)
    return JBatch(*(jnp.asarray(a) for a in (images, sizes, boxes, mask,
                                              labels)))


@pytest.fixture(scope="module")
def written(narrow, tmp_path_factory):
    """{case: checkpoint directory} written by the JAX package."""
    base = tmp_path_factory.mktemp("orbax")
    out = {}
    for case, opts in (("wsod", ()), ("wsod_cdb", ("DB.METHOD", "concrete"))):
        cfg = _wsod_cfg(*opts)
        state = _random_state(jax_build_model(cfg), cfg, _wsod_batch(), 4,
                              seed=len(out))
        JaxCheckpointer(str(base / case)).save(5, state)
        out[case] = str(base / case / "model_0000005")
    cfg = jax_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "coco",
                                     "coco_mask_rcnn_smoke.yaml"))
    model = jax_build_model(cfg)
    rng = np.random.RandomState(4)
    b, p = 2, 8
    x1y1 = rng.uniform(0, 40, (b, p, 2))
    boxes = np.concatenate([x1y1, x1y1 + 20], -1).astype(np.float32)
    batch = JBatch(jnp.asarray(rng.randn(b, 64, 96, 3), jnp.float32),
                   jnp.full((b, 2), 64.0).at[:, 1].set(96.0),
                   jnp.asarray(boxes), jnp.ones((b, p), bool),
                   jnp.zeros((b, cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES)))
    state = _random_state(model, cfg, batch, 0, seed=7)
    JaxCheckpointer(str(base / "mask_rcnn")).save(5, state)
    out["mask_rcnn"] = str(base / "mask_rcnn" / "model_0000005")
    # sharded jax.Arrays: several chunks a leaf; bfloat16, <i4, a scalar
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                             ("a", "b"))
    spec = jax.sharding.PartitionSpec
    tree = {"f32": jax.device_put(
                jnp.asarray(rng.randn(24, 10), jnp.float32),
                jax.sharding.NamedSharding(mesh, spec("a", None))),
            "bf16": jax.device_put(
                jnp.asarray(rng.randn(8, 6), jnp.bfloat16),
                jax.sharding.NamedSharding(mesh, spec("a", "b"))),
            "i4": jnp.int32(-3), "nested": {"scalar": 2.5}}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(base / "chunks"), tree)
    ckptr.wait_until_finished()
    out["chunks"] = str(base / "chunks")
    return out


@pytest.mark.parametrize("case", ["wsod", "wsod_cdb", "mask_rcnn", "chunks"])
def test_every_leaf_equals_orbax_restore(written, case):
    got = orbax_import.load_orbax(written[case])
    _assert_same_leaves(got, _restore(written[case]))
    if case == "chunks":
        store = OcdbtStore(written[case])
        assert sum(k.startswith(b"f32/") for k in store.keys()) == 1 + 8
        assert sum(k.startswith(b"bf16/") for k in store.keys()) == 1 + 8
        assert got["bf16"].dtype == torch.bfloat16
    if case == "wsod_cdb":
        inner = got["opt_state"]["inner_states"]["cdb_weight"]["inner_state"]
        assert isinstance(inner, list) and "trace" in inner[0]


def test_edge_chunks_are_cropped(tmp_path):
    rng = np.random.RandomState(2)
    arrays = {"x": (rng.randn(12, 9).astype("<f4"), [5, 7]),
              "y": (rng.randint(-9, 9, (7,)).astype("<i4"), [3]),
              "z": (rng.randn(2, 3, 5).astype("<f8"), [1, 2, 4])}
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    for name, (a, chunks) in arrays.items():
        t = ts.open({"driver": "zarr", "kvstore": {**kv, "path": name + "/"},
                     "metadata": {"chunks": chunks, "dtype": a.dtype.str,
                                  "shape": list(a.shape),
                                  "compressor": {"id": "zstd", "level": 3}}},
                    create=True).result()
        t.write(a).result()
    store = OcdbtStore(str(tmp_path))
    for name, (a, _) in arrays.items():
        got = orbax_import.read_array(store, name)
        assert got.dtype == a.dtype and np.array_equal(got, a), name


def test_the_fixture_equals_orbax_restore_native_and_plain():
    want = _restore(FIXTURE_CKPT)
    _assert_same_leaves(orbax_import.load_orbax(FIXTURE_CKPT), want)
    _assert_same_leaves(orbax_import.load_orbax(
        FIXTURE_CKPT, decompress=zstd.decompress_plain), want)
    store = OcdbtStore(FIXTURE_CKPT)
    refs = [v for v in store._index.values() if isinstance(v, tuple)]
    assert any(v[0].startswith("ocdbt.process_0/d/") for v in refs)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 2 * 1024 * 1024


def _port_cfg():
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(ROOT, FX["config"]))
    cfg.merge_from_list(FX["opts"])
    cfg.freeze()
    return cfg


def test_fixture_eval_matches_jax_and_the_npz(narrow, tmp_path):
    e = np.load(os.path.join(FIXTURE, "expected.npz"))
    batch = Batch(*(torch.from_numpy(e[k]) for k in ("images", "sizes",
                                                     "boxes", "mask")),
                  torch.zeros(e["images"].shape[0], 21))
    outs = []
    npz = str(tmp_path / "params.npz")
    save_npz(npz, jax.tree_util.tree_map(np.asarray,
                                         _restore(FIXTURE_CKPT)["params"]))
    for sd in (load_model_weights(FIXTURE_CKPT), state_dict_from_jax(npz)):
        model = build_model(_port_cfg())
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            outs.append(model.eval_forward(batch))
    (s, b), (s2, b2) = outs
    assert torch.equal(s, s2) and torch.equal(b, b2)
    np.testing.assert_allclose(s.numpy(), e["scores"], rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(b.numpy().reshape(e["pred_boxes"].shape),
                               e["pred_boxes"], rtol=0, atol=BOX_ATOL)


def _draws(n_rows, cap_a, channels):
    def arr(x):
        return torch.from_numpy(np.array(x))

    return {"dropblock": arr(jax.random.uniform(KEYS[3], (n_rows, 7, 7))),
            "sim_drop": arr(jax.random.uniform(KEYS[1], (cap_a, 7, 7))),
            "noise": arr(jax.random.normal(KEYS["noise"],
                                           (cap_a, 7, 7, channels),
                                           jnp.float32))}


def test_resumed_step_matches_the_jax_step(narrow):
    """The fixture resumed by the port (model, momentum, counts, step) and
    by the JAX package's own ``Checkpointer.load``, then one step each."""
    from make_orbax_fixture import batch_arrays

    cfg = _wsod_cfg()
    arrays = batch_arrays(2)
    jbatch = JBatch(*(jnp.asarray(a) for a in arrays))
    jmodel = jdet.WSODDetector(**KW, freeze_convs=4)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        jbatch, method="init_all"))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    tx, _ = jax_make_optimizer(cfg.SOLVER, zeros, 4)
    target = TrainState(step=np.int32(0), params=zeros,
                        opt_state=tx.init(zeros),
                        rng=np.asarray(jax.random.PRNGKey(0)))
    state, found = JaxCheckpointer(os.path.dirname(FIXTURE_CKPT),
                                   save=False).load(target, FIXTURE_CKPT)
    assert found and int(state.step) == FX["step"]
    with pytest.MonkeyPatch.context() as mp:
        fixed_key_draws(mp)
        new_state, logs = jax.jit(make_train_step(jmodel, tx))(state, jbatch)
    want_logs = {k: float(v) for k, v in logs.items()}

    model = WSODDetector(**KW, freeze_at=2)
    optimizer, _ = make_optimizer(cfg.SOLVER, model)
    generator = torch.Generator().manual_seed(cfg.SEED)
    seeded = generator.get_state()
    start = Checkpointer(FIXTURE, save=False).load(model, optimizer,
                                                   generator, FIXTURE_CKPT)
    assert start == FX["step"] and optimizer.count == FX["step"]
    # the JAX rng is not carried over (ROADMAP Queue 3)
    assert torch.equal(generator.get_state(), seeded)
    names = {id(p): n for n, p in model.named_parameters()}
    saved = {}
    for label in ("weight", "bias"):
        saved.update(state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, _drop_none(
                state.opt_state.inner_states[label].inner_state.trace))))
    for group in optimizer.param_groups:
        for p in group["params"]:
            buf = optimizer.state[p]["momentum_buffer"]
            assert torch.equal(buf, saved[names[id(p)]]), names[id(p)]
    n_rows = arrays[2].shape[0] * arrays[2].shape[1]
    got = train_step(model, optimizer, Batch(*(torch.from_numpy(a)
                                               for a in arrays)),
                     draws=_draws(n_rows, KW["cap_a"], model.backbone.out_channels))
    for k in INT_METRICS:
        assert float(got[k]) == want_logs[k], k
    assert want_logs["n_bank"] > 0
    for k in ("loss", "loss_img", "loss_sim", "loss_ref_cls0",
              "loss_ref_reg0"):
        np.testing.assert_allclose(float(got[k]), want_logs[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    want_params = leaves(new_state.params)
    got_params = leaves(jax_params_from_state_dict(model.state_dict()))
    for k in want_params:
        np.testing.assert_allclose(got_params[k], want_params[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    bufs = {names[id(p)]: optimizer.state[p]["momentum_buffer"]
            for g in optimizer.param_groups for p in g["params"]}
    want_traces = {}
    for label in ("weight", "bias"):
        want_traces.update(state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, _drop_none(
                new_state.opt_state.inner_states[label].inner_state.trace))))
    assert want_traces.keys() == bufs.keys()
    for name, want in want_traces.items():
        scale = max(float(want.abs().max()), 1e-12)
        below = any(name.startswith(f"backbone.conv{i}.") for i in range(10))
        rel = GRAD_REL_BELOW_CONV10 if below else GRAD_REL
        np.testing.assert_allclose(bufs[name].numpy(), want.numpy(), rtol=0,
                                   atol=max(rel * scale, GRAD_ATOL_FLOOR),
                                   err_msg=name)
    assert int(new_state.opt_state.inner_states["weight"].inner_state.count) \
        == optimizer.count == FX["step"] + 1


def _drop_none(tree):
    """A trace tree without optax's MaskedNode leaves."""
    if isinstance(tree, dict):
        out = {k: _drop_none(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree if hasattr(tree, "shape") else None


# -- what is not read ---------------------------------------------------------

def test_a_leaf_that_is_not_an_array_raises(tmp_path):
    dst = tmp_path / "ckpt"
    shutil.copytree(FIXTURE_CKPT, dst)
    meta = json.loads((dst / "_METADATA").read_text())
    key = "('step',)"
    meta["tree_metadata"][key]["value_metadata"]["value_type"] = "string"
    (dst / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="step: leaf type 'string'"):
        orbax_import.load_orbax(str(dst))
    meta["tree_metadata"][key]["value_metadata"]["value_type"] = "np.ndarray"
    for flag, value in (("use_zarr3", True), ("use_ocdbt", False)):
        (dst / "_METADATA").write_text(json.dumps({**meta, flag: value}))
        with pytest.raises(ValueError, match=flag):
            orbax_import.load_orbax(str(dst))


class _Store(dict):
    """A dict of str keys with the OcdbtStore methods read_array uses."""
    decompress = staticmethod(zstd.decompress)

    def get(self, key):
        return self[key]


def _zarray(**kw):
    z = {"chunks": [2], "compressor": {"id": "zstd", "level": 1},
         "dimension_separator": ".", "dtype": "<f4", "fill_value": None,
         "filters": None, "order": "C", "shape": [2], "zarr_format": 2}
    z.update(kw)
    return json.dumps(z).encode()


@pytest.mark.parametrize("bad,match", [
    (dict(compressor={"id": "blosc"}), "compressor 'blosc'"),
    (dict(filters=[{"id": "delta"}]), "filters"),
    (dict(order="F"), "order 'F'"),
    ("zarr.json", "zarr v3"),
    ("missing chunk", "chunk w/0 is missing"),
])
def test_unread_zarr_features_raise_naming_the_key(bad, match):
    import zstandard

    chunk = zstandard.ZstdCompressor().compress(
        np.arange(2, dtype="<f4").tobytes())
    store = _Store({"w/.zarray": _zarray(), "w/0": chunk})
    np.testing.assert_array_equal(orbax_import.read_array(store, "w"),
                                  np.arange(2, dtype="<f4"))
    if bad == "zarr.json":
        store["w/zarr.json"] = b"{}"
    elif bad == "missing chunk":
        del store["w/0"]
    else:
        store["w/.zarray"] = _zarray(**bad)
    with pytest.raises(ValueError, match=f"^w.*{match}"):
        orbax_import.read_array(store, "w")


def test_unimported_optimizer_states_raise(narrow):
    tree = orbax_import.load_orbax(FIXTURE_CKPT)
    model = build_model(_port_cfg())
    multi = {"mini_step": 0, "gradient_step": 0,
             "inner_opt_state": tree["opt_state"], "acc_grads": {}}
    optimizer, _ = make_optimizer(_port_cfg().SOLVER, model)
    with pytest.raises(ValueError, match="MultiSteps"):
        optimizer_state_from_jax(multi, model, optimizer)
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(ROOT, FX["config"]))
    cfg.merge_from_list([*FX["opts"], "MODEL.BACKBONE.FREEZE_CONV_BODY_AT",
                         "1"])
    model = build_model(cfg)
    optimizer, _ = make_optimizer(cfg.SOLVER, model)
    with pytest.raises(ValueError, match="backbone.conv2.weight: no "
                                         "momentum trace"):
        optimizer_state_from_jax(tree["opt_state"], model, optimizer)


@pytest.mark.slow
def test_full_width_main_config_state_imports_bit_exactly(tmp_path):
    """The main config's full-width VGG16-OICR TrainState (~135M params and
    as many momentum values, random, shapes from ``jax.eval_shape``) saved
    by the JAX package, imported by the port: every leaf equal to orbax's
    restore. Prints the import's wall time and the native decoder's MB/s
    (this host's CPU)."""
    import time

    cfg = jax_cfg()
    cfg.merge_from_file(os.path.join(ROOT, FX["config"]))
    model = jax_build_model(cfg)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        _wsod_batch(), method="init_all"))["params"]
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, np.float32) * 0.01, shapes)
    tx, _ = jax_make_optimizer(cfg.SOLVER, params, 4)
    opt_state = jax.tree_util.tree_map(
        lambda x: (np.full(x.shape, 9, x.dtype)
                   if jnp.issubdtype(x.dtype, jnp.integer)
                   else rng.standard_normal(x.shape, np.float32)),
        jax.eval_shape(tx.init, params))
    state = TrainState(step=np.int32(9), params=params, opt_state=opt_state,
                       rng=np.asarray(jax.random.PRNGKey(0)))
    JaxCheckpointer(str(tmp_path)).save(9, state)
    del state, params, opt_state
    path = str(tmp_path / "model_0000009")
    decoded = {"bytes": 0, "s": 0.0}

    def timed(data):
        t = time.perf_counter()
        out = zstd.decompress(data)
        decoded["s"] += time.perf_counter() - t
        decoded["bytes"] += len(out)
        return out

    t0 = time.perf_counter()
    got = orbax_import.load_orbax(path, decompress=timed)
    wall = time.perf_counter() - t0
    n = sum(v.size for v in jax.tree_util.tree_leaves(got)
            if isinstance(v, np.ndarray))
    print(f"\n[full width] {n} values, {decoded['bytes'] / 1e9:.3f} GB "
          f"decoded: import {wall:.2f} s, native zstd "
          f"{decoded['bytes'] / 1e6 / decoded['s']:.1f} MB/s (CPU host)")
    assert n > 2 * 130e6
    _assert_same_leaves(got, _restore(path))
