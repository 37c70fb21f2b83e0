"""The port's int8 accuracy study (odwscl_tpu_torch/tools/
int8_accuracy_study.py) against the JAX package's (tools/
int8_accuracy_study.py), on the CPU.

- The data: the port's writer in the JAX tool's layout
  (``write_synthetic_voc(trainval_first=True)``) gives the files of
  tools/make_synthetic_voc.py:main at the same arguments: every JPEG, XML
  and split list byte for byte, the proposal pickles equal once loaded
  (more GT jitters than ``n_props`` on some images: none is cut).
- The tool end to end through its real subprocesses (``train_net``, then
  ``test_net`` in the three modes): 2 seeds, 2 steps, 4 / 2 images of
  64x96, the heads narrowed and f32 through the trailing opts. Then the
  JAX tool runs on the same root with its CLI calls stubbed out: it reads
  the port's ``result.txt`` files with its own ``read_map`` and writes
  its JSON, which must equal the port's (the same schema, the same maps,
  and the deltas and spreads of the same arithmetic, to the bit).
- ``TPU.INT8_BF16_LAYERS (4,5,6)`` leaves conv4-conv6 in bf16 in both
  packages: the JAX backbone built from the JAX config's value calls the
  int8 conv for the other eight of conv2-conv12 and the float conv for
  those three; the port's detector built from the port's config takes the
  same eight (``int8_convs``), and its dynamic forward runs eight int8
  convs on inputs of the same channel counts.
No tolerance applies.
"""

import filecmp
import importlib.util
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import odwscl_tpu.ops.quant as jq
from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.models.detector import detector_from_cfg as jax_detector
from odwscl_tpu.models.vgg16 import VGGBackbone as JVGGBackbone
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.models import build_model
from odwscl_tpu_torch.models import vgg16 as tvgg
from odwscl_tpu_torch.tools import int8_accuracy_study as study

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "voc", "voc07_synth_smoke.yaml")


def _jax_tool(name, monkeypatch):
    """A module of the JAX package's tools/ (its sys.path edits undone
    after the test)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_writer_matches_the_jax_tool(tmp_path, monkeypatch):
    gen = _jax_tool("make_synthetic_voc", monkeypatch)
    kw = dict(n_train=3, n_test=2, img_hw=(120, 144), n_props=8)
    gen.main(str(tmp_path / "jax"), seed=5, **kw)
    write_synthetic_voc(str(tmp_path / "port"), n_test=2, seed=5,
                        img_hw=(120, 144), n_props=8, n_trainval=3,
                        trainval_first=True)
    voc = os.path.join("voc", "VOC2007")
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax" / voc)
                   for f in fs)
    assert len(files) == 2 * 5 + 2, files
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    with open(tmp_path / "jax" / voc / "ImageSets" / "Main" /
              "trainval.txt") as f:
        assert f.read() == "000001\n000002\n000003\n"
    n_boxes = []
    for split in ("trainval", "test"):
        loaded = []
        for side in ("jax", "port"):
            with open(tmp_path / side / "proposal" /
                      f"SS-voc07_{split}.pkl", "rb") as f:
                loaded.append(pickle.load(f))
        want, got = loaded
        assert got["indexes"] == want["indexes"]
        for g, w in zip(got["boxes"], want["boxes"], strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        n_boxes += [len(b) for b in got["boxes"]]
    assert max(n_boxes) > 8, n_boxes     # GT jitters past n_props, kept


def test_study_runs_and_matches_the_jax_tool(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    root = tmp_path / "study"
    args = ["--seeds", "1234", "4321", "--iters", "2", "--n-train", "4",
            "--n-test", "2", "--img-h", "64", "--img-w", "96",
            "--n-props", "16", "--root", str(root), "--device", "cpu"]
    opts = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "TPU.COMPUTE_DTYPE",
            "float32", "TPU.PROPOSAL_BUCKETS", "(32,)",
            "TPU.IMAGE_PAD_MULTIPLE", "32", "DATALOADER.NUM_WORKERS", "0"]
    got = study.main(args + opts)
    with open(root / "INT8_STUDY.json") as f:
        assert json.load(f) == got
    for seed in ("1234", "4321"):
        maps = got["seeds"][seed]
        assert set(maps) == {"bf16", "int8", "int8-fb"}
        assert all(0.0 <= v <= 1.0 for v in maps.values()), maps
        sdir = root / f"seed{seed}"
        # the trained checkpoint (last_checkpoint's) evaluated, never a
        # random init; one OUTPUT_DIR a mode: the calibrated scales of the
        # 11 int8 convs in int8's, of all but conv4-conv6 in int8-fb's
        assert (sdir / "train" / "model_0000002.pt").exists()
        with open(root / f"seed{seed}.log") as f:
            log = f.read()
        assert log.count("Inference: 2 images") == 3
        assert "evaluating a random init" not in log
        assert not (sdir / "eval_bf16" / "int8_scales.npz").exists()
        convs = {m: sorted(int(k.split("conv")[1].split("_")[0]) for k in
                           np.load(sdir / f"eval_{m}" / "int8_scales.npz"))
                 for m in ("int8", "int8-fb")}
        assert convs == {"int8": list(range(2, 13)),
                         "int8-fb": [2, 3, 7, 8, 9, 10, 11, 12]}
    with open(root / "timing.json") as f:
        timing = json.load(f)
    assert timing["wall_s"] > 0
    assert all(v > 0 for t in timing["seeds"].values() for v in t.values())

    # the JAX tool on the same root, its CLI calls stubbed: its own
    # read_map on the port's result.txt files, its own arithmetic
    tool = _jax_tool("int8_accuracy_study", monkeypatch)
    calls = []
    monkeypatch.setattr(tool, "run", lambda cmd, log: calls.append(cmd))
    monkeypatch.setattr(sys, "argv", ["int8_accuracy_study.py"] + args[:-2]
                        + ["--out", str(tmp_path / "jax.json")])
    tool.main()
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert got == want
    assert len(calls) == 2 * 4      # train, 3 x test, for each seed
    assert tool.read_map(str(root / "seed1234" / "eval_int8")) == \
        got["seeds"]["1234"]["int8"]

    # a second run finds everything on disk and runs no CLI
    monkeypatch.setattr(study, "run", lambda cmd, log: calls.append(cmd))
    assert study.main(args + opts) == got
    assert len(calls) == 2 * 4


def test_bf16_layers_match(monkeypatch):
    opts = ["TPU.INT8_EVAL", "True", "TPU.INT8_EVAL_CONVS", "True",
            "TPU.INT8_BF16_LAYERS", "(4,5,6)",
            "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64"]
    jcfg = jax_cfg()
    jcfg.merge_from_file(CONFIG)
    jcfg.merge_from_list(opts)
    layers = jax_detector(jcfg).int8_bf16_layers
    assert layers == (4, 5, 6)
    calls = []
    orig_int8, orig_ref = jq.conv2d_int8, jq.conv2d_ref

    def int8(x, kernel, *a, **kw):
        calls.append(("int8", kernel.shape[2]))
        return orig_int8(x, kernel, *a, **kw)

    def ref(x, kernel, *a, **kw):
        calls.append(("ref", kernel.shape[2]))
        return orig_ref(x, kernel, *a, **kw)

    monkeypatch.setattr(jq, "conv2d_int8", int8)
    monkeypatch.setattr(jq, "conv2d_ref", ref)
    x = np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32)
    jbb = JVGGBackbone(arch="VGG16-OICR", compute_dtype=jnp.float32,
                       int8_eval=True, int8_bf16_layers=layers)
    params = jax.jit(jbb.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    jbb.apply(params, jnp.asarray(x), fast_eval=True)
    assert len(calls) == 11
    want = {i + 2 for i, (kind, _) in enumerate(calls) if kind == "int8"}
    assert want == {2, 3, 7, 8, 9, 10, 11, 12}

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(opts + ["TPU.COMPUTE_DTYPE", "float32"])
    bb = build_model(cfg).backbone
    assert set(bb.int8_convs()) == want
    seen = []
    orig_conv = tvgg.conv_int8_nhwc

    def conv(xq, *a, **kw):
        seen.append(xq.shape[-1])
        return orig_conv(xq, *a, **kw)

    monkeypatch.setattr(tvgg, "conv_int8_nhwc", conv)
    with torch.no_grad():
        bb(torch.from_numpy(x), fast_eval=True)
    assert seen == [c for kind, c in calls if kind == "int8"]
