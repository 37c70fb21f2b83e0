"""The reference's first training steps, and what the check reads of them.

From the seed's weights, the written images and the generator state the
program's first step started from: the sampler's first batches, the
transforms from the same JPEG bytes and per-sample ``RandomState``, the
contrastive train forward, the backward, and SGD with momentum as the port's
``solver/build.py`` has it (the warmup schedule in float32, weight decay
added to the gradient, the bias group's LR factor).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import weights as W
from . import data as D
from .model import Detector, param_shapes
from .precision import Precision, no_tf32


def warmup_lr(s: dict, count: int) -> float:
    """The LR of update ``count`` (linear warmup, float32 arithmetic)."""
    f32 = np.float32
    t = f32(count)
    if count >= s["warmup_iters"]:
        wf = f32(1.0)
    else:
        alpha = np.clip(t / f32(max(s["warmup_iters"], 1)), f32(0), f32(1))
        wf = f32(s["warmup_factor"]) * (f32(1) - alpha) + alpha
    n_decay = sum(count >= m for m in s["lr_steps"])
    return float(f32(s["base_lr"]) * wf * (f32(s["gamma"]) ** f32(n_decay)))


def load_sample(rec, min_size: float) -> dict:
    from PIL import Image

    with Image.open(rec.path) as im:
        img = im.convert("RGB")
    w, h = img.size
    return {"image": img, "size": (w, h),
            "rois": D.clean_proposals(rec.proposals, w, h, min_size)}


def train_batch(records, idx, it: int, s: dict, device) -> dict:
    """The collated batch of iteration ``it`` over dataset indices ``idx``
    (with ``half_batch``, a planted fault: the first half of them)."""
    if s.get("half_batch"):
        idx = idx[:len(idx) // 2]
    samples, labels = [], []
    for i in idx:
        rng = np.random.RandomState((s["data_seed"] + it * 100003 + int(i))
                                    % (2 ** 31))
        samples.append(D.train_transform(
            load_sample(records[int(i)], s["proposal_min_size"]), rng,
            s["train_scales"], s["train_max"]))
        labels.append(D.image_labels(records[int(i)].labels,
                                     s["num_classes"]))
    return D.collate(samples, np.stack(labels), s["size_div"],
                     s["pad_multiple"], s["buckets"], device)


def run_steps(records, s: dict, seed: int, gen_state: torch.Tensor,
              device, steps: int = 3, precision: str = "f32") -> dict:
    """Readings of ``steps`` reference steps: each step's losses, the first
    gradient's norm per leaf (and the gradient itself of the leaves named
    by ``s["grad_leaves"]``), and the change of each leaf after the last
    step. Planted faults, for the reference put in the program's place:
    ``s["lr_scale"]`` scales every learning rate; ``s["half_batch"]``
    and ``s["pool_grad_route"]`` (``Detector.train_forward``)."""
    with no_tf32():
        return _run_steps(records, s, seed, gen_state, device, steps,
                          precision)


def _run_steps(records, s, seed, gen_state, device, steps, precision):
    shapes = param_shapes(s["num_classes"], s["mlp_dim"], s["num_refs"],
                          s["pooled"])
    params = W.make_weights(shapes, seed, device)
    det = Detector(params, s, Precision(precision))
    train = det.trainable()
    for t in train.values():
        t.requires_grad_(True)
    p0 = {n: t.detach().clone() for n, t in train.items()}
    groups = np.array([1 if r.size[1] > r.size[0] else 0 for r in records])
    order = D.first_batches(len(records), s["batch"], groups, steps)
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    bufs: Dict[str, torch.Tensor] = {}
    out: Dict[str, Dict] = {"losses": [], "grad_norm": {}, "change_norm": {},
                            "first_grad": {}}
    for k in range(steps):
        batch = train_batch(records, order[k], k, s, device)
        losses, _ = det.train_forward(batch, gen)
        total = torch.stack(list(losses.values())).sum()
        total.backward()
        out["losses"].append({"loss": float(total.detach()), **{
            n: float(v.detach()) for n, v in losses.items()}})
        lr = warmup_lr(s, k + 1) * s.get("lr_scale", 1.0)
        with torch.no_grad():
            for n, t in train.items():
                bias = n.endswith(".bias")
                wd = s["weight_decay_bias"] if bias else s["weight_decay"]
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                if k == 0:
                    out["grad_norm"][n] = float(g.double().norm())
                    if n.startswith(s["grad_leaves"]):
                        out["first_grad"][n] = g.detach().float().cpu()
                g = g + wd * t if wd else g
                buf = bufs.get(n)
                buf = bufs[n] = g.clone() if buf is None else (
                    buf.mul_(s["momentum"]).add_(g))
                factor = s["bias_lr_factor"] if bias else 1.0
                t.add_(-(lr * factor) * buf)
                t.grad = None
    for n, t in train.items():
        out["change_norm"][n] = float((t.detach() - p0[n]).double().norm())
    return out
