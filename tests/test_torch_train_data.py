"""The port's training input pipeline, solver, checkpoint and CLI.

- ``make_train_loader`` (TrainTransform with random scale, flips and PCA
  lighting, IterationBatchSampler with aspect grouping, the collator)
  gives the JAX package's very arrays for the same seed and iterations, on
  a synthetic trainval split: exact.
- The LR schedule, the momentum correction and ITER_SIZE accumulation
  against the JAX ``make_optimizer`` (+ ``optax.MultiSteps``) over a
  warmup and a milestone, on the same gradients: 1e-6 relative (f32
  updates; the port's LR factors are products in f64 before the cast).
- ITER_SIZE 2 through ``train_net.update_iters`` and the optimizer,
  stepped once per iteration: MAX_ITER and CHECKPOINT_PERIOD double, the
  full LR first applies at iteration 2 * WARMUP_ITERS and each milestone
  at iteration 2 * STEPS (the JAX CLI, which also scales STEPS and
  WARMUP_ITERS, puts them at 4 * STEPS). Exact iterations.
- ``tools/train_net.py`` on the CPU: 4 iterations straight and 2 + a
  resume for 2 more from the checkpoint give the same parameters: the data
  are seeded by the absolute iteration and the dropout draws by the
  generator state that the checkpoint carries. Bound 1e-7 absolute: two
  straight runs already differ by up to 4e-9 (the CPU convolutions'
  backward reduces over threads in no fixed order), while a lost RNG or
  data state moves the parameters by ~1e-3.
"""

import os

import numpy as np
import optax
import pytest
import torch

from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.data import make_train_loader as jax_make_train_loader
from odwscl_tpu.solver import make_optimizer as jax_make_optimizer
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data.build import make_train_loader
from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.solver import make_optimizer
from odwscl_tpu_torch.tools import train_net
from odwscl_tpu_torch.utils.checkpoint import load_model_weights

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "voc", "voc07_synth_smoke.yaml")
DATA_OPTS = ["INPUT.MIN_SIZE_TRAIN", "(96, 128, 112)",
             "INPUT.MAX_SIZE_TRAIN", "160", "SOLVER.IMS_PER_BATCH", "2",
             "SOLVER.MAX_ITER", "5", "DATALOADER.NUM_WORKERS", "2"]
TRAIN_OPTS = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
              "TPU.COMPUTE_DTYPE", "float32", "TPU.BANK_CAPACITY", "64",
              "SOLVER.CHECKPOINT_PERIOD", "2", "DATALOADER.NUM_WORKERS", "1"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    write_synthetic_voc(root, n_test=2, seed=0, img_hw=(120, 144),
                        n_props=64, n_trainval=6)
    return root


def _cfg(get_default, opts):
    cfg = get_default()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def test_train_loader_matches_jax(data):
    jbatches = list(jax_make_train_loader(_cfg(jax_cfg, DATA_OPTS),
                                          data_root=data))
    batches = list(make_train_loader(_cfg(get_default_cfg, DATA_OPTS), 0,
                                     data))
    assert len(batches) == len(jbatches) == 5
    sizes = set()
    for got, want in zip(batches, jbatches):
        for name in ("images", "image_sizes", "boxes", "box_mask", "labels"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        sizes.add(tuple(got.images.shape[1:3]))
        assert got.labels.sum() > 0
    assert len(sizes) > 1                    # the random scales differ

    # a resumed loader yields the same batches from its start iteration
    resumed = list(make_train_loader(_cfg(get_default_cfg, DATA_OPTS), 3,
                                     data))
    assert len(resumed) == 2
    for got, want in zip(resumed, batches[3:]):
        assert torch.equal(got.images, want.images)


class _Params(torch.nn.Module):
    """A frozen backbone conv and a neck layer, named as the detector's."""

    def __init__(self, arrays):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.conv0 = torch.nn.Module()
        self.neck = torch.nn.Module()
        self.neck.fc6 = torch.nn.Module()
        for path, v in arrays.items():
            mod, leaf = path.rsplit(".", 1)
            self.get_submodule(mod).register_parameter(
                leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))
        self.backbone.conv0.requires_grad_(False)


@pytest.mark.parametrize("iter_size", [1, 2])
def test_solver_matches_jax(iter_size):
    rng = np.random.RandomState(0)
    shapes = {"backbone.conv0.weight": (3, 4), "backbone.conv0.bias": (4,),
              "neck.fc6.weight": (5, 3), "neck.fc6.bias": (3,)}
    arrays = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    opts = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "3",
            "SOLVER.STEPS", "(4, 6)", "SOLVER.GAMMA", "0.1",
            "SOLVER.ITER_SIZE", str(iter_size)]
    model = _Params(arrays)
    opt, schedule = make_optimizer(_cfg(get_default_cfg, opts).SOLVER, model)

    jcfg = _cfg(jax_cfg, opts)
    jparams = {"backbone": {"conv0": {
        "kernel": arrays["backbone.conv0.weight"],
        "bias": arrays["backbone.conv0.bias"]}},
        "neck": {"fc6": {"kernel": arrays["neck.fc6.weight"],
                         "bias": arrays["neck.fc6.bias"]}}}
    tx, jschedule = jax_make_optimizer(jcfg.SOLVER, jparams, 1)
    if iter_size > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=iter_size)
    for k in range(10):
        assert schedule(k) == pytest.approx(float(jschedule(k)), rel=1e-7)
    jstate = tx.init(jparams)
    names = {"neck.fc6.weight": ("neck", "fc6", "kernel"),
             "neck.fc6.bias": ("neck", "fc6", "bias")}
    lr_changes = 0
    for step in range(8 * iter_size):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n])
        lr_before = schedule(opt.count + 1)
        opt.step()
        lr_changes += schedule(opt.count + 1) != lr_before
        jgrads = {"backbone": {"conv0": {
            "kernel": grads["backbone.conv0.weight"],
            "bias": grads["backbone.conv0.bias"]}},
            "neck": {"fc6": {"kernel": grads["neck.fc6.weight"],
                             "bias": grads["neck.fc6.bias"]}}}
        upd, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, (a, b, c) in names.items():
            np.testing.assert_allclose(
                model.get_parameter(n).detach().numpy(),
                np.asarray(jparams[a][b][c]), rtol=1e-6, atol=1e-7,
                err_msg=f"{step} {n}")
    assert torch.equal(model.backbone.conv0.weight,
                       torch.from_numpy(arrays["backbone.conv0.weight"]))
    assert lr_changes >= 3      # warmup steps and milestones: corrections


def test_iter_size_milestones_at_k_times_steps():
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(["SOLVER.ITER_SIZE", "2", "SOLVER.STEPS", "(4, 6)",
                         "SOLVER.WARMUP_ITERS", "2", "SOLVER.MAX_ITER", "8",
                         "SOLVER.CHECKPOINT_PERIOD", "3", "SOLVER.BASE_LR",
                         "0.5", "SOLVER.MOMENTUM", "0.0",
                         "SOLVER.WEIGHT_DECAY", "0.0"])
    train_net.update_iters(cfg)
    assert cfg.SOLVER.MAX_ITER == 16 and cfg.SOLVER.CHECKPOINT_PERIOD == 6
    assert tuple(cfg.SOLVER.STEPS) == (4, 6)
    assert cfg.SOLVER.WARMUP_ITERS == 2
    model = _Params({"neck.fc6.weight": np.zeros((2,), np.float32)})
    opt, _ = make_optimizer(cfg.SOLVER, model)
    w = model.neck.fc6.weight
    lrs = {}                     # iteration (1-based) -> the LR it applied
    for it in range(1, cfg.SOLVER.MAX_ITER + 1):
        w.grad = torch.ones_like(w)
        before = w.detach().clone()
        if opt.step():
            lrs[it] = float((before - w.detach())[0])
    assert sorted(lrs) == list(range(2, 17, 2))

    def first(lr):
        return min(it for it, v in lrs.items() if v == pytest.approx(lr))

    assert lrs[2] < 0.5                                       # warmup
    assert first(0.5) == 2 * cfg.SOLVER.WARMUP_ITERS
    assert [first(0.05), first(0.005)] == [2 * s for s in cfg.SOLVER.STEPS]


def _train(data, out, max_iter):
    return train_net.main(["--config-file", CONFIG, "--data-root", data,
                           "--device", "cpu", "--skip-test",
                           "OUTPUT_DIR", str(out),
                           "SOLVER.MAX_ITER", str(max_iter)] + TRAIN_OPTS)


def test_train_net_resume_continues_the_trajectory(data, tmp_path):
    _train(data, tmp_path / "straight", 4)
    _train(data, tmp_path / "resumed", 2)
    assert os.path.exists(tmp_path / "resumed" / "model_0000002.pt")
    timing = {}
    train_net.main(["--config-file", CONFIG, "--data-root", data,
                    "--device", "cpu", "--skip-test",
                    "OUTPUT_DIR", str(tmp_path / "resumed"),
                    "SOLVER.MAX_ITER", "4"] + TRAIN_OPTS, timing_out=timing)
    assert [s["iter"] for s in timing["train"]["steps"]] == [3, 4]
    assert all(np.isfinite(s["loss"]) for s in timing["train"]["steps"])
    straight = load_model_weights(str(tmp_path / "straight" /
                                      "model_final.pt"))
    resumed = load_model_weights(str(tmp_path / "resumed" / "model_final.pt"))
    assert straight.keys() == resumed.keys()
    moved = 0
    first = load_model_weights(str(tmp_path / "resumed" / "model_0000002.pt"))
    for k in straight:
        np.testing.assert_allclose(resumed[k].numpy(), straight[k].numpy(),
                                   rtol=0, atol=1e-7, err_msg=k)
        moved += not torch.equal(first[k], resumed[k])
    assert moved > 0


def test_train_net_raises_on_missing_weights_and_absent_card(data, tmp_path):
    with pytest.raises(FileNotFoundError):
        train_net.main(["--config-file", CONFIG, "--data-root", data,
                        "--device", "cpu", "--skip-test",
                        "OUTPUT_DIR", str(tmp_path),
                        "MODEL.WEIGHT", "catalog://ImageNetPretrained/MSRA/R-50"]
                       + TRAIN_OPTS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_net.main(["--config-file", CONFIG, "--data-root", data,
                            "--skip-test", "OUTPUT_DIR", str(tmp_path)])
