"""The port's proposal converter (odwscl_tpu_torch/tools/proposal_convert.py)
against the JAX package's tools/proposal_convert.py.

MATLAB files written with ``scipy.io.savemat`` in both layouts (one
Selective Search ``.mat`` with a ``boxes`` cell array; one MCG ``.mat`` an
image, with ``bboxes`` / ``bboxes_scores`` for web data), 1-indexed
(y1, x1, y2, x2), over synthetic VOC (``voc_2007_test``), COCO
(``coco_2017_val``) and web (``flickr_coco``) datasets, go through both
tools; the pickles must be equal: the same image ids (VOC: the file
stem; COCO and web: the dataset's ids), int16 0-indexed xyxy boxes and
float32 scores. Also ``convert_ss_boxes`` against the JAX function.
"""

import importlib.util
import os
import pickle

import numpy as np
import pytest

from odwscl_tpu_torch.data.proposals import convert_ss_boxes
from odwscl_tpu_torch.data.synthetic import (write_synthetic_coco,
                                             write_synthetic_voc)
from odwscl_tpu_torch.tools import proposal_convert as port

sio = pytest.importorskip("scipy.io")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_proposal_convert", os.path.join(REPO, "tools",
                                             "proposal_convert.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    voc = str(tmp_path_factory.mktemp("voc"))
    write_synthetic_voc(voc, n_test=3, n_props=4)
    coco = str(tmp_path_factory.mktemp("coco"))
    write_synthetic_coco(coco, 2, 3, n_props=4, web=True)
    return {"voc_2007_test": voc, "coco_2017_val": coco,
            "flickr_coco": coco}


def _mat_boxes(rng, n):
    y1x1 = rng.randint(1, 60, (n, 2))
    hw = rng.randint(3, 40, (n, 2))
    return np.concatenate([y1x1, y1x1 + hw], 1).astype(np.float64)


def _stems(tool, name, root):
    ds = tool.build_dataset(name, None, root) if tool is port else \
        tool.build_dataset(name, None, False, root)
    return [os.path.basename(ds.get_img_info(i)["file_name"])[:-4]
            for i in range(len(ds))]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_equal(a, b):
    assert set(a) == set(b) == {"boxes", "scores", "indexes"}
    assert a["indexes"] == b["indexes"]
    for key in ("boxes", "scores"):
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_selective_search_matches_jax(roots, tmp_path):
    name, root = "voc_2007_test", roots["voc_2007_test"]
    rng = np.random.RandomState(0)
    cells = np.empty((3,), object)
    for i in range(3):
        cells[i] = _mat_boxes(rng, 5 + i)
    mat = str(tmp_path / "ss.mat")
    sio.savemat(mat, {"boxes": cells.reshape(1, 3)})
    port.main(["ss", name, mat, str(tmp_path / "port.pkl"),
               "--data-root", root])
    _jax_tool().convert_ss(name, mat, str(tmp_path / "jax.pkl"), root)
    got, want = _load(tmp_path / "port.pkl"), _load(tmp_path / "jax.pkl")
    _assert_equal(got, want)
    assert got["indexes"] == [1, 2, 3]
    np.testing.assert_array_equal(got["boxes"][0],
                                  (cells[0][:, (1, 0, 3, 2)] - 1)
                                  .astype(np.int16))
    with pytest.raises(ValueError, match="holds 2 images"):
        sio.savemat(mat, {"boxes": cells[:2].reshape(1, 2)})
        port.convert_ss(name, mat, str(tmp_path / "short.pkl"), root)


@pytest.mark.parametrize("name", ["voc_2007_test", "coco_2017_val",
                                  "flickr_coco"])
def test_mcg_matches_jax(roots, tmp_path, name):
    root = roots[name]
    web = "flickr" in name
    rng = np.random.RandomState(1)
    mcg = tmp_path / "mcg"
    mcg.mkdir()
    for stem in _stems(port, name, root):
        n = rng.randint(2, 9)
        sio.savemat(str(mcg / f"{stem}.mat"), {
            ("bboxes" if web else "boxes"): _mat_boxes(rng, n),
            ("bboxes_scores" if web else "scores"):
                rng.uniform(size=(n, 1))})
    port.convert_mcg(name, str(mcg), str(tmp_path / "port.pkl"), root)
    _jax_tool().convert_mcg(name, str(mcg), str(tmp_path / "jax.pkl"), root)
    got = _load(tmp_path / "port.pkl")
    _assert_equal(got, _load(tmp_path / "jax.pkl"))
    assert len(got["indexes"]) == len(_stems(port, name, root))


def test_convert_ss_boxes_matches_jax():
    from odwscl_tpu.data.proposals import convert_ss_boxes as jax_convert

    b = _mat_boxes(np.random.RandomState(2), 7) + 0.5
    np.testing.assert_array_equal(convert_ss_boxes(b), jax_convert(b))
