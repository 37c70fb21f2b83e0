"""The port's multi-process prediction gather
(odwscl_tpu_torch/engine/inference.py:gather_predictions) against the JAX
package's (odwscl_tpu/engine/inference.py:gather_predictions), as
tests/test_multihost.py holds the JAX one: shards merge in the order of
the global image index, a missing shard times out, overlapping shards
raise, one process writes nothing. The merged lists of both packages are
compared on the same dicts (exact). Also the eval loader's sharding by
rank and the test_net refusal of an Orbax checkpoint directory.
"""

import importlib
import os
import pickle

import numpy as np
import pytest

jinf = importlib.import_module("odwscl_tpu.engine.inference")
tinf = importlib.import_module("odwscl_tpu_torch.engine.inference")


def _shards(n, count):
    rng = np.random.RandomState(n)
    return [{i: {"img": i, "boxes": rng.rand(3, 4).astype(np.float32)}
             for i in range(r, n, count)} for r in range(count)]


@pytest.mark.parametrize("count", [2, 3])
def test_shards_merge_in_global_order(tmp_path, count):
    n = 11
    shards = _shards(n, count)
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    out_t.mkdir()
    out_j.mkdir()
    for r in range(count - 1, 0, -1):       # the other ranks write first
        assert tinf.gather_predictions(shards[r], n, str(out_t), count,
                                       r) is None
        assert jinf.gather_predictions(shards[r], n, str(out_j), count,
                                       r) is None
    merged = tinf.gather_predictions(shards[0], n, str(out_t), count, 0,
                                     timeout_s=5)
    want = jinf.gather_predictions(shards[0], n, str(out_j), count, 0,
                                   timeout_s=5)
    assert [d["img"] for d in merged] == list(range(n))
    assert len(merged) == len(want)
    for a, b in zip(merged, want):
        assert a["img"] == b["img"]
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
    # every shard file was written whole (no temporary left behind)
    names = sorted(os.listdir(out_t))
    assert names == [f"predictions_shard_{r}.pkl" for r in range(count)]


def test_missing_shard_times_out(tmp_path):
    with pytest.raises(TimeoutError, match="shard 1"):
        tinf.gather_predictions({0: {"img": 0}}, 2, str(tmp_path), 2, 0,
                                timeout_s=0.3)


def test_overlapping_shards_raise(tmp_path):
    with open(tmp_path / "predictions_shard_1.pkl", "wb") as f:
        pickle.dump({0: {"img": 0}}, f)        # overlaps rank 0's ids
    with pytest.raises(RuntimeError, match="overlap"):
        tinf.gather_predictions({0: {"img": 0}}, 2, str(tmp_path), 2, 0,
                                timeout_s=5)


def test_missing_images_raise(tmp_path):
    with open(tmp_path / "predictions_shard_1.pkl", "wb") as f:
        pickle.dump({1: {"img": 1}}, f)
    with pytest.raises(RuntimeError, match="gathered 2 predictions"):
        tinf.gather_predictions({0: {"img": 0}}, 3, str(tmp_path), 2, 0,
                                timeout_s=5)


def test_single_process_returns_sorted_and_writes_nothing(tmp_path):
    preds = {3: {"img": 3}, 0: {"img": 0}, 1: {"img": 1}}
    got = tinf.gather_predictions(preds, 3, str(tmp_path))
    assert got == jinf.gather_predictions(preds, 3, str(tmp_path), 1, 0)
    assert [d["img"] for d in got] == [0, 1, 3]
    assert os.listdir(tmp_path) == []
    # several processes need a folder to meet in
    with pytest.raises(ValueError, match="output_folder"):
        tinf.gather_predictions(preds, 3, None, 2, 0)


def test_eval_loader_shards_by_rank(tmp_path):
    """make_eval_loaders shards the test split process_index::count, as the
    JAX InferenceSampler does; without torch.distributed it is whole."""
    from odwscl_tpu.data.samplers import InferenceSampler as JSampler
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "voc",
                                     "voc07_synth_smoke.yaml"))
    write_synthetic_voc(str(tmp_path), n_test=5, seed=0, img_hw=(40, 48),
                        n_props=4, prop_size=(8, 20), obj_size=(10, 20),
                        test_proposal_file=cfg.PROPOSAL_FILES.TEST[0])
    (_, whole), = make_eval_loaders(cfg, str(tmp_path))
    assert whole.sampler.indices.tolist() == list(range(5))
    for r in range(2):
        (_, part), = make_eval_loaders(cfg, str(tmp_path), 2, r)
        want = JSampler(5, batch_size=cfg.TEST.IMS_PER_BATCH,
                        process_count=2, process_index=r).indices
        assert part.sampler.indices.tolist() == list(want)


def test_test_net_names_what_an_orbax_directory_lacks(tmp_path):
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.tools.test_net import load_model

    ckpt = tmp_path / "checkpoint_20000"      # an Orbax checkpoint's shape
    ckpt.mkdir()
    (ckpt / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="no 'tree_metadata'"):
        load_model(get_default_cfg(), str(ckpt))
    (ckpt / "_METADATA").unlink()
    with pytest.raises(ValueError, match="no _METADATA file"):
        load_model(get_default_cfg(), str(ckpt))


def test_test_net_loads_an_orbax_checkpoint(monkeypatch):
    """tests/data/orbax_wsod_small (written by the JAX package's
    Checkpointer.save): load_model imports its params exactly."""
    import json

    import odwscl_tpu_torch.models.vgg16 as tvgg
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.tools.test_net import load_model
    from odwscl_tpu_torch.utils.orbax_import import load_orbax

    root = os.path.join(os.path.dirname(__file__), "data",
                        "orbax_wsod_small")
    with open(os.path.join(root, "fixture.json")) as f:
        fx = json.load(f)
    monkeypatch.setitem(tvgg.VGG_CFGS, "VGG16-OICR", fx["VGG16-OICR"])
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..",
                                     fx["config"]))
    cfg.merge_from_list(fx["opts"])
    model = load_model(cfg, os.path.join(root, fx["checkpoint"]))
    params = load_orbax(os.path.join(root, fx["checkpoint"]))["params"]
    want = params["neck"]["fc6"]["kernel"]                 # (in, out)
    assert np.array_equal(model.neck.fc6.weight.detach().numpy(), want.T)
    want = params["backbone"]["conv12"]["kernel"]          # HWIO
    assert np.array_equal(model.backbone.conv12.weight.detach().numpy(),
                          want.transpose(3, 2, 0, 1))


_WORKER = r"""
import os, sys
import torch.distributed as dist
rank, port, out, data, cfg_path = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                   sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        world_size=2, rank=rank)
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data.build import make_eval_loaders
from odwscl_tpu_torch.engine.inference import gather_predictions
cfg = get_default_cfg()
cfg.merge_from_file(cfg_path)
(_, loader), = make_eval_loaders(cfg, data)
preds = {int(i): {"img": int(i), "rank": rank}
         for _, _, idxs in loader for i in idxs}
merged = gather_predictions(preds, len(loader.dataset), out, timeout_s=60)
dist.barrier()
print("RESULT", rank, None if merged is None else
      [(d["img"], d["rank"]) for d in merged])
dist.destroy_process_group()
"""


def test_two_processes_shard_and_gather(tmp_path):
    """Two processes in a gloo process group: each evaluates its rank's
    shard of the test split (make_eval_loaders) and gather_predictions,
    with the rank and world size taken from torch.distributed, hands rank 0
    the whole split in order; rank 1 returns None."""
    import socket
    import subprocess
    import sys

    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc

    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs", "voc",
                            "voc07_synth_smoke.yaml")
    data = str(tmp_path / "data")
    write_synthetic_voc(data, n_test=5, seed=0, img_hw=(40, 48), n_props=4,
                        prop_size=(8, 20), obj_size=(10, 20))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), port,
                               str(tmp_path), data, cfg_path],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o + e
    results = dict(line.split(" ", 2)[1:] for o, _ in outs
                   for line in o.splitlines() if line.startswith("RESULT"))
    assert results["1"] == "None"
    assert results["0"] == str([(i, i % 2) for i in range(5)])
