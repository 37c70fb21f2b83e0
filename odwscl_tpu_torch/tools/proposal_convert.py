"""Convert MATLAB Selective Search / MCG proposals to the pickle format.

    python -m odwscl_tpu_torch.tools.proposal_convert ss  <dataset_name> \
        <file_in.mat> <file_out.pkl> [--data-root DIR]
    python -m odwscl_tpu_torch.tools.proposal_convert mcg <dataset_name> \
        <dir_in> <file_out.pkl> [--data-root DIR]

Counterpart of ``tools/proposal_convert.py``, with its conventions:
Selective Search comes as one ``.mat`` whose ``boxes`` cell array holds
one array an image in the dataset's order; MCG as one ``<stem>.mat`` an
image (``boxes`` and ``scores``; ``bboxes`` and ``bboxes_scores`` for a
web ``flickr`` dataset). Both are 1-indexed (y1, x1, y2, x2) and become
0-indexed xyxy int16 boxes; Selective Search gets scores of 1. The image
id is the dataset's own id for COCO and web data, the file stem without
its underscore for a ``2012`` VOC set, else the stem as an integer. The
output is ``{'boxes', 'scores', 'indexes'}``, as ``data/proposals.py``
reads it. Needs scipy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.build import build_dataset
from ..data.proposals import convert_ss_boxes, write_proposal_pickle


def image_index(dataset, dataset_name: str, i: int):
    """Image ``i``'s id in the pickle."""
    stem = os.path.basename(dataset.get_img_info(i)["file_name"])[:-4]
    if "coco" in dataset_name or "flickr" in dataset_name:
        return dataset.get_origin_id(i)
    if "2012" in dataset_name:
        return int("".join(stem.split("_")))
    return int(stem)


def convert_ss(dataset_name: str, file_in: str, file_out: str,
               data_root: str = "datasets") -> int:
    """One Selective Search ``.mat`` -> ``file_out``; returns the image
    count."""
    import scipy.io as sio

    dataset = build_dataset(dataset_name, None, data_root)
    raw = sio.loadmat(file_in)["boxes"].ravel()
    if raw.shape[0] != len(dataset):
        raise ValueError(f"{file_in} holds {raw.shape[0]} images, "
                         f"{dataset_name} {len(dataset)}")
    boxes, scores, ids = [], [], []
    for i in range(len(dataset)):
        b = convert_ss_boxes(raw[i])
        boxes.append(b.astype(np.int16))
        scores.append(np.ones(len(b), np.float32))
        ids.append(image_index(dataset, dataset_name, i))
    write_proposal_pickle(file_out, boxes, ids, scores)
    return len(ids)


def convert_mcg(dataset_name: str, dir_in: str, file_out: str,
                data_root: str = "datasets") -> int:
    """A directory of per-image MCG ``.mat`` files -> ``file_out``; returns
    the image count."""
    import scipy.io as sio

    dataset = build_dataset(dataset_name, None, data_root)
    web = "flickr" in dataset_name
    boxes, scores, ids = [], [], []
    for i in range(len(dataset)):
        stem = os.path.basename(dataset.get_img_info(i)["file_name"])[:-4]
        mat = sio.loadmat(os.path.join(dir_in, f"{stem}.mat"))
        b = convert_ss_boxes(mat["bboxes" if web else "boxes"])
        boxes.append(b.astype(np.int16))
        scores.append(np.squeeze(np.asarray(
            mat["bboxes_scores" if web else "scores"], np.float32)))
        ids.append(image_index(dataset, dataset_name, i))
    write_proposal_pickle(file_out, boxes, ids, scores)
    return len(ids)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="MATLAB proposals -> pickle")
    ap.add_argument("kind", choices=["ss", "mcg"])
    ap.add_argument("dataset_name")
    ap.add_argument("path_in")
    ap.add_argument("file_out")
    ap.add_argument("--data-root", default="datasets")
    a = ap.parse_args(argv)
    convert = convert_ss if a.kind == "ss" else convert_mcg
    n = convert(a.dataset_name, a.path_in, a.file_out, a.data_root)
    print(f"wrote {n} images -> {a.file_out}")
    return n


if __name__ == "__main__":
    main()
