"""The training mix: the port's ``do_train`` fed by its ``TrainLoader``.

Set-up writes the configuration's synthetic training split, builds the
detector with the seed's weights, the optimizer and the loader, and runs
the first ``check_steps`` steps through ``do_train`` one at a time,
reading what the check compares: each step's losses, the first gradient
(from the momentum buffers after step 1) and each leaf's change after the
last. It then warms the backbone at every padded canvas that a batch of
the split can take. The window runs ``do_train`` on the same model,
optimizer, generator and loader until ``--seconds`` have passed, and the
check runs the reference over the same first steps.
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from .. import data, program
from ..reference import train as ref_train
from ..trace import span


# the leaves that only the MIL loss reaches: the WSDDN heads, whose first
# gradient is continuous in the inputs (every other leaf also takes the
# refinement and SupCon terms, which hang on discrete mining choices)
MIL_LEAVES = ("pred.cls_score.", "pred.det_score.")
# the leaves whose gradient comes back through ROIPool's backward (#2)
BACKBONE_LEAVES = ("backbone.",)


class State:
    pass


def setup(run) -> State:
    from odwscl_tpu_torch.data.build import make_train_loader
    from odwscl_tpu_torch.solver import make_optimizer

    st = State()
    st.run, traffic = run, run.cell.traffic
    cfg = st.cfg = program.build_cfg(run.cell.config, traffic, run.extra)
    st.records = data.write_split(run.data_root, cfg.DATASETS.TRAIN[0],
                                  cfg.PROPOSAL_FILES.TRAIN[0],
                                  run.cell.config["dataset"], run.seed)
    st.model = program.build_model(cfg, run.seed, run.device)
    st.optimizer, _ = make_optimizer(cfg.SOLVER, st.model, None,
                                     cfg.DB.WEIGHT)
    st.generator = torch.Generator(device=run.device).manual_seed(
        run.seed % (1 << 63))
    st.gen_state = st.generator.get_state()
    st.loader = make_train_loader(cfg, 0, run.data_root)
    st.batches = iter(st.loader)
    st.steps = int(traffic["check_steps"])
    st.readings = first_steps(st)
    st.canvases = split_canvases(st)
    if run.warm:
        warm_canvases(st)
    return st


def first_steps(st: State) -> dict:
    """Run the first steps one at a time; read each step's losses, the
    first gradient's norm per leaf and each leaf's change."""
    from odwscl_tpu_torch.engine.trainer import do_train

    train = [(n, p) for n, p in st.model.named_parameters()
             if p.requires_grad]
    wd = {id(p): g["weight_decay"] for g in st.optimizer.param_groups
          for p in g["params"]}
    p0 = {n: p.detach().clone() for n, p in train}
    out = {"losses": [], "grad_norm": {}, "change_norm": {},
           "first_grad": {}}
    for k in range(st.steps):
        timing = {}
        do_train(st.model, st.optimizer, itertools.islice(st.batches, 1),
                 k + 1, st.run.device, st.generator, start_iter=k,
                 log_period=0, timing_out=timing)
        row = timing["steps"][-1]
        out["losses"].append({n: v for n, v in row.items()
                              if n == "loss" or n.startswith("loss_")})
        if k == 0:
            for n, p in train:
                buf = st.optimizer.state[p].get("momentum_buffer")
                g = (torch.zeros_like(p) if buf is None
                     else buf - wd[id(p)] * p0[n])
                out["grad_norm"][n] = float(g.double().norm())
                if n.startswith(MIL_LEAVES + BACKBONE_LEAVES):
                    out["first_grad"][n] = g.float().cpu()
    for n, p in train:
        out["change_norm"][n] = float((p.detach() - p0[n]).double().norm())
    return out


def split_canvases(st: State):
    """Every padded canvas (h, w) that a batch of the split can take: a
    batch holds images of one aspect group, each resized at one of the
    training scales, and its canvas is their largest height by their
    largest width, padded."""
    from odwscl_tpu_torch.data.transforms import get_resize_size

    cfg = st.cfg
    mult = math.lcm(cfg.DATALOADER.SIZE_DIVISIBILITY,
                    cfg.TPU.IMAGE_PAD_MULTIPLE)

    def pad(x):
        return int(math.ceil(x / mult) * mult)

    out = set()
    for portrait in (False, True):
        hw = {get_resize_size(r.size, scale, cfg.INPUT.MAX_SIZE_TRAIN)
              for r in st.records if (r.size[1] > r.size[0]) == portrait
              for scale in cfg.INPUT.MIN_SIZE_TRAIN}
        out |= {(pad(ha), pad(wb)) for ha, wa in hw for hb, wb in hw
                if hb <= ha and wa <= wb}
    return sorted(out, key=lambda c: -c[0] * c[1])


def warm_canvases(st: State) -> None:
    """The backbone's forward and backward at each canvas of the split, so
    that no convolution meets a new shape inside the window."""
    b = st.cfg.SOLVER.IMS_PER_BATCH
    for h, w in st.canvases:
        x = torch.zeros((b, h, w, 3), device=st.run.device)
        st.model.backbone(x).float().sum().backward()
    st.model.zero_grad(set_to_none=True)
    if st.run.device.type == "cuda":
        torch.cuda.synchronize(st.run.device)


def window(st: State, seconds: float) -> dict:
    from odwscl_tpu_torch.engine.trainer import do_train

    waits, shapes = [], []
    deadline = time.perf_counter() + seconds

    def feed():
        while time.perf_counter() < deadline:
            t = time.perf_counter()
            with span("bench.loader_next"):
                batch = next(st.batches)
            waits.append(time.perf_counter() - t)
            shapes.append((tuple(batch.images.shape), batch.boxes,
                           batch.box_mask))
            yield batch

    timing = {}
    t0 = time.perf_counter()
    do_train(st.model, st.optimizer, feed(), 1 << 40, st.run.device,
             st.generator, start_iter=st.steps, log_period=0,
             timing_out=timing)
    wall = time.perf_counter() - t0
    steps = timing["steps"]
    bad = sum(1 for s in steps
              if not all(math.isfinite(v) for k, v in s.items()
                         if k == "loss" or k.startswith("loss_")))
    b = st.cfg.SOLVER.IMS_PER_BATCH
    q = np.quantile([s["step_s"] for s in steps] or [0.0], [0.25, 0.5, 0.75])
    w = np.quantile(waits or [0.0], [0.5, 0.9])
    cold = {s[0][1:3] for s in shapes} - set(st.canvases)
    diag = (f"step ms p25/p50/p75 {q[0] * 1e3:.1f}/{q[1] * 1e3:.1f}/"
            f"{q[2] * 1e3:.1f}, loader wait ms p50/p90 {w[0] * 1e3:.1f}/"
            f"{w[1] * 1e3:.1f}, canvases not warmed {sorted(cold)}")
    return {"kind": "train", "steps": len(steps), "images": len(steps) * b,
            "diag": diag,
            "wall_s": wall, "failed": bad, "data_wait_s": waits,
            "shapes": shapes[:len(steps)],
            "model": program.model_shape(st.cfg), "itemsize": 2
            if st.cfg.TPU.COMPUTE_DTYPE == "bfloat16" else 4,
            "pooler_scale": st.cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES[0]}


def end_to_end(counts: dict) -> dict:
    return {"train_images_per_s": counts["images"] / counts["wall_s"]}


def release(st: State) -> None:
    """Free the program's state before the reference runs."""
    st.batches.close()
    for name in ("model", "optimizer", "loader", "batches", "generator"):
        setattr(st, name, None)


def reference_readings(st: State, precision: str = "f32",
                       **fault) -> dict:
    s = {**program.reference_settings(st.cfg),
         "grad_leaves": MIL_LEAVES + BACKBONE_LEAVES, **fault}
    return ref_train.run_steps(st.records, s, st.run.seed, st.gen_state,
                               st.run.device, st.steps, precision)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``:

    - ``loss_img_gap``: the worst step's relative gap of the MIL loss
      (``loss_img``, continuous in the forward; the refinement and SupCon
      terms hang on discrete mining choices);
    - ``mil_grad_gap``: for the leaves that only the MIL loss reaches
      (the WSDDN heads, ``MIL_LEAVES``), the worst distance of the
      program's first gradient from the reference's, against the larger of
      the leaf's and the median leaf's reference norm;
    - ``backbone_grad_gap``: the same for the backbone's trained leaves,
      whose gradient comes back through ROIPool's backward;
    - ``change_gap``: the worst leaf's gap of the norms of its change after
      the steps, against the larger of the leaf's and the median leaf's;
    - ``change_median_gap``: the median leaf's of the same gaps (the
      update's scale: the learning rate and the momentum).

    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out."""
    loss = max(abs(p["loss_img"] - r["loss_img"]) / abs(r["loss_img"])
               for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norm"]
    g_med = float(np.median(list(g_ref.values())))
    kept = [n for n, v in g_ref.items() if v >= 1e-3 * g_med]

    def grad_gap(leaves):
        return max(float((prog["first_grad"][n] - ref["first_grad"][n])
                         .double().norm()) / max(g_ref[n], g_med)
                   for n in kept if n.startswith(leaves))

    c_ref = ref["change_norm"]
    c_med = float(np.median([c_ref[n] for n in kept]))
    change = [abs(prog["change_norm"][n] - c_ref[n]) / max(c_ref[n], c_med)
              for n in kept]
    return {"loss_img_gap": loss, "mil_grad_gap": grad_gap(MIL_LEAVES),
            "backbone_grad_gap": grad_gap(BACKBONE_LEAVES),
            "change_gap": max(change),
            "change_median_gap": float(np.median(change))}


def check(st: State) -> dict:
    return compare(st.readings, reference_readings(st))
