"""The port's weight importers (odwscl_tpu_torch/utils/weight_import.py)
against the JAX package's, on the CPU, and the warm start of the port's
training CLI.

Each test writes a small file in a reference layout with random values
from a seeded numpy generator: a torchvision VGG16 ``.pth`` (both
classifier namings), a trained reference OD-WSCL ``.pth`` (mlp_dim 64)
and a Caffe2 detectron ResNet ``.pkl`` (R-50 layout, blobs of res2-res4
plus one res5 blob that the C4 backbone has no place for). The JAX
importer fills a numpy zero tree in the shapes ``jax.eval_shape`` gives
(it only checks shapes); the port's importer fills the port model loaded
with the same zeros through utils/from_jax.py. The two state_dicts must
be equal exactly (no tolerance: both copy the file's f32 values, and the
layout changes are permutations), and both importers must log the same
count. fc6 must compute the reference's (C, 7, 7) flatten: 1e-4 relative
(one f32 dot product of 25088 terms in two orders).

``warm_start`` dispatches on the suffix: ``.pt`` (port), ``.pkl``
(detectron), ``.pth`` without "model" in its basename (ImageNet VGG16),
any other ``.pth`` (reference checkpoint). ``train_net`` on the CPU
warm-starts an R-18-C5 detector from a ``.pkl`` through the catalog and
takes 2 finite steps; the frozen stem and layer1 (FREEZE_CONV_BODY_AT 2)
still hold the file's values exactly afterwards.
"""

import logging
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import odwscl_tpu.models.resnet as jresnet
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.models import WSODDetector as JWSODDetector
from odwscl_tpu.utils import weight_import as jwi
from odwscl_tpu_torch.data.synthetic import detectron_resnet_blobs
from odwscl_tpu_torch.models import WSODDetector
from odwscl_tpu_torch.models.resnet import ResNetBackbone
from odwscl_tpu_torch.tools import train_net
from odwscl_tpu_torch.utils import weight_import as wi
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP = 64
VGG_CH = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
FC6_RTOL = 1e-4


def _zeros(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)


def _detector_zeros():
    model = JWSODDetector(compute_dtype="float32", mlp_dim=MLP)
    batch = JBatch(jnp.zeros((1, 64, 64, 3)), jnp.full((1, 2), 64.0),
                   jnp.array([[[0.0, 0.0, 40.0, 40.0]] * 4]),
                   jnp.ones((1, 4), bool), jnp.zeros((1, 21)))
    return _zeros(jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch,
        method="init_all"))["params"])


def _randn(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _counts(caplog, logger):
    return [int(m) for r in caplog.records if r.name == logger
            for m in re.findall(r"Imported (\d+)", r.getMessage())]


def _both(jax_import, port_import, zeros, port_model, path, caplog):
    """(JAX's tree through the bridge, the port's state_dict)."""
    with caplog.at_level(logging.INFO):
        want = state_dict_from_jax(jax_import(zeros, path))
        port_model.load_state_dict(state_dict_from_jax(zeros))
        port_model.load_state_dict(port_import(port_model.state_dict(),
                                               path))
    counts = (_counts(caplog, "odwscl_tpu.weights"),
              _counts(caplog, "odwscl_tpu_torch.weights"))
    assert counts[0] == counts[1] and len(counts[0]) == 1, counts
    return want, port_model.state_dict()


def _assert_equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _tv_vgg16(rng, fc_names):
    sd, cin = {}, 3
    for tv, cout in zip(wi._TV_VGG16_CONV_IDX, VGG_CH):
        sd[f"features.{tv}.weight"] = torch.from_numpy(
            _randn(rng, cout, cin, 3, 3))
        sd[f"features.{tv}.bias"] = torch.from_numpy(_randn(rng, cout))
        cin = cout
    fc6, fc7 = fc_names
    sd[f"classifier.{fc6}.weight"] = torch.from_numpy(
        _randn(rng, MLP, 512 * 49))
    sd[f"classifier.{fc6}.bias"] = torch.from_numpy(_randn(rng, MLP))
    sd[f"classifier.{fc7}.weight"] = torch.from_numpy(_randn(rng, MLP, MLP))
    sd[f"classifier.{fc7}.bias"] = torch.from_numpy(_randn(rng, MLP))
    return sd


@pytest.mark.parametrize("fc_names", [(0, 3), (1, 4)])
def test_vgg16_imagenet_matches_jax(tmp_path, caplog, fc_names):
    rng = np.random.default_rng(0)
    sd = _tv_vgg16(rng, fc_names)
    path = str(tmp_path / "vgg16-00b39a1b.pth")
    torch.save(sd, path)
    model = WSODDetector(mlp_dim=MLP, compute_dtype="float32")
    want, got = _both(jwi.import_vgg16_imagenet, wi.import_vgg16_imagenet,
                      _detector_zeros(), model, path, caplog)
    _assert_equal(want, got)
    assert torch.equal(got["backbone.conv12.weight"], sd["features.28.weight"])

    # fc6: the port flattens the pooled roi as (h, w, C), the reference
    # as (C, h, w)
    pooled = _randn(rng, 7, 7, 512)
    ours = model.neck.fc6(torch.from_numpy(pooled.reshape(1, -1)))[0]
    w6 = sd[f"classifier.{fc_names[0]}.weight"].numpy()
    b6 = sd[f"classifier.{fc_names[0]}.bias"].numpy()
    theirs = w6 @ pooled.transpose(2, 0, 1).reshape(-1) + b6
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=FC6_RTOL,
                               atol=FC6_RTOL * np.abs(theirs).max())


def test_vgg16_imagenet_partial_and_mismatch(tmp_path, caplog):
    rng = np.random.default_rng(1)
    sd = _tv_vgg16(rng, (0, 3))
    for tv in wi._TV_VGG16_CONV_IDX[10:]:
        del sd[f"features.{tv}.weight"], sd[f"features.{tv}.bias"]
    path = str(tmp_path / "vgg16_partial.pth")
    torch.save(sd, path)
    model = WSODDetector(mlp_dim=MLP, compute_dtype="float32")
    want, got = _both(jwi.import_vgg16_imagenet, wi.import_vgg16_imagenet,
                      _detector_zeros(), model, path, caplog)
    _assert_equal(want, got)
    # the count includes fc6 and fc7, as the JAX importer's does
    assert "Only 12/13 convs matched" in caplog.text
    assert not got["backbone.conv12.weight"].any()       # untouched zeros

    sd["classifier.3.weight"] = torch.zeros(MLP, MLP + 1)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        jwi.import_vgg16_imagenet(_detector_zeros(), path)
    with pytest.raises(ValueError, match="shape mismatch"):
        wi.import_vgg16_imagenet(model.state_dict(), path)


def _reference_checkpoint(rng, model):
    """A reference OD-WSCL state_dict of the port model's shapes, with the
    fc6 input in the reference's (C, 7, 7) order (a shape-preserving
    relabelling: random values either way)."""
    sd, seq, idx = {}, [], 0
    for v in wi._OICR_SPEC:
        if v in ("M", "I"):
            idx += 1
        else:
            seq.append(idx)
            idx += 2
    names = {f"backbone.conv{i}": f"backbone.body.features.{si}"
             for i, si in enumerate(seq)}
    names.update({"neck.fc6": "roi_heads.feature_extractor.classifier.1",
                  "neck.fc7": "roi_heads.feature_extractor.classifier.4",
                  "sim_net.mlp0": "roi_heads.model_sim.mlp.0",
                  "sim_net.mlp1": "roi_heads.model_sim.mlp.2"})
    names.update({f"pred.{h}": f"roi_heads.predictor.{h}"
                  for h in wi._PRED_HEADS})
    for key, t in model.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        sd[f"{names[mod]}.{leaf}"] = torch.from_numpy(_randn(rng, *t.shape))
    return sd


def test_reference_checkpoint_matches_jax(tmp_path, caplog):
    rng = np.random.default_rng(2)
    model = WSODDetector(mlp_dim=MLP, compute_dtype="float32")
    sd = _reference_checkpoint(rng, model)
    path = str(tmp_path / "model_final.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()},
                "iteration": 30000}, path)
    want, got = _both(jwi.import_reference_checkpoint,
                      wi.import_reference_checkpoint, _detector_zeros(),
                      model, path, caplog)
    _assert_equal(want, got)
    assert _counts(caplog, "odwscl_tpu_torch.weights") == [13 + 4 + 8]
    assert torch.equal(got["pred.ref2.weight"],
                       sd["roi_heads.predictor.ref2.weight"])
    assert torch.equal(got["backbone.conv12.weight"],
                       sd["backbone.body.features.28.weight"])


def test_detectron_resnet_matches_jax(tmp_path, caplog):
    rng = np.random.default_rng(3)
    model = nn.ModuleDict({"backbone": ResNetBackbone("R-50", 4,
                                                      torch.float32)})
    blobs = detectron_resnet_blobs("R-50", 4, seed=3)
    # blobs the C4 backbone has no place for: a res5 conv, the classifier
    blobs["res5_0_branch2a_w"] = _randn(rng, 512, 1024, 1, 1)
    blobs["fc1000_w"] = _randn(rng, 10, 2048)
    path = str(tmp_path / "R-50.pkl")
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    jm = jresnet.ResNetBackbone("R-50", 4, compute_dtype=jnp.float32)
    zeros = {"backbone": _zeros(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"])}
    want, got = _both(jwi.import_detectron_resnet, wi.import_detectron_resnet,
                      zeros, model, path, caplog)
    _assert_equal(want, got)
    n_convs = sum(k.endswith("_w") for k in blobs) - 2
    assert _counts(caplog, "odwscl_tpu_torch.weights") == [n_convs]
    assert "skip res5_0_branch2a_w" in caplog.text
    for key, blob in (("stem_conv.weight", "conv1_w"),
                      ("stem_bn.scale", "res_conv1_bn_s"),
                      ("layer1_0.conv3.weight", "res2_0_branch2c_w"),
                      ("layer1_0.downsample_bn.bias", "res2_0_branch1_bn_b"),
                      ("layer3_5.bn2.scale", "res4_5_branch2b_bn_s")):
        assert np.array_equal(got["backbone." + key].numpy(), blobs[blob])
    assert not got["backbone.layer3_5.bn2.mean"].any()


class _Recorder(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(2, 2)
        self.calls = []


@pytest.mark.parametrize("name,importer", [
    ("model_0000010.pt", None),
    ("R-50.pkl", "import_detectron_resnet"),
    ("vgg16-00b39a1b.pth", "import_vgg16_imagenet"),
    ("model_final.pth", "import_reference_checkpoint")])
def test_warm_start_dispatch(tmp_path, monkeypatch, name, importer):
    from odwscl_tpu_torch.config import get_default_cfg

    model = _Recorder()
    for fn in ("import_detectron_resnet", "import_vgg16_imagenet",
               "import_reference_checkpoint"):
        monkeypatch.setattr(wi, fn, lambda sd, path, fn=fn: (
            model.calls.append((fn, path)) or sd))
    weights = tmp_path / "weights"
    weights.mkdir()
    path = str(weights / name)
    saved = {"lin.weight": torch.ones(2, 2), "lin.bias": torch.ones(2)}
    torch.save(saved, path)
    cfg = get_default_cfg()
    catalog = {"R-50.pkl": "catalog://ImageNetPretrained/MSRA/R-50",
               "vgg16-00b39a1b.pth":
                   "catalog://VGGImageNetPretrained/JCJOHNS/VGG-16"}
    cfg.merge_from_list(["MODEL.WEIGHT", catalog.get(name, path)])
    assert train_net.warm_start(cfg, model, str(tmp_path)) == path
    if importer is None:
        assert not model.calls
        assert torch.equal(model.lin.weight, saved["lin.weight"])
    else:
        assert model.calls == [(importer, path)]
    cfg.merge_from_list(["MODEL.WEIGHT", str(weights / "absent.pkl")])
    with pytest.raises(FileNotFoundError):
        train_net.warm_start(cfg, model, str(tmp_path))


def test_train_net_warm_starts_resnet_from_pkl(tmp_path):
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc

    data = str(tmp_path / "data")
    write_synthetic_voc(data, n_test=2, n_trainval=4, seed=0)
    blobs = {k: v for k, v in detectron_resnet_blobs("R-18", 5, 4).items()
             if k.startswith(("conv1", "res_conv1", "res2_", "res5_"))}
    blobs["res5_0_branch2c_w"] = blobs["res5_0_branch2b_w"]  # not in R-18
    os.makedirs(os.path.join(data, "weights"))
    with open(os.path.join(data, "weights", "R-50.pkl"), "wb") as f:
        pickle.dump(blobs, f)
    out = str(tmp_path / "out")
    timing = {}
    train_net.main([
        "--config-file", os.path.join(REPO, "configs", "voc",
                                      "voc07_synth_smoke.yaml"),
        "--data-root", data, "--device", "cpu", "--skip-test",
        "OUTPUT_DIR", out, "SOLVER.MAX_ITER", "2",
        "MODEL.BACKBONE.CONV_BODY", "R-18-C5",
        "MODEL.ROI_BOX_HEAD.POOLER_SCALES", "(0.0625,)",
        "MODEL.WEIGHT", "catalog://ImageNetPretrained/MSRA/R-50",
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
        "TPU.COMPUTE_DTYPE", "float32"], timing_out=timing)
    steps = timing["train"]["steps"]
    assert len(steps) == 2
    assert all(np.isfinite(v) for s in steps for v in s.values())
    sd = torch.load(os.path.join(out, "model_final.pt"),
                    weights_only=True)["model"]
    for key, blob in (("stem_conv.weight", "conv1_w"),
                      ("stem_bn.bias", "res_conv1_bn_b"),
                      ("layer1_1.conv2.weight", "res2_1_branch2b_w")):
        assert np.array_equal(sd["backbone." + key].numpy(), blobs[blob])
