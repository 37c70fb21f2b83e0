"""int8 serving accuracy study: the mAP cost of static int8 serving on a
trained model, over seeds.

Counterpart of ``tools/int8_accuracy_study.py``, with the same flags,
defaults, data and JSON. For each seed it trains the synthetic VOC smoke
config (configs/voc/voc07_synth_smoke.yaml at the study's sizes) through
``python -m odwscl_tpu_torch.tools.train_net``, then evaluates the trained
checkpoint through ``python -m odwscl_tpu_torch.tools.test_net`` in three
modes, each in an ``OUTPUT_DIR`` of its own (so ``int8_scales.npz`` and
the cached predictions never cross modes):

  bf16        the float serving path
  int8        static-calibrated int8 serving (``test_net --int8``: the
              calibration forwards run on the trained weights first)
  int8-fb     int8 with ``TPU.INT8_BF16_LAYERS`` (default conv4-conv6,
              the early conv3 block) kept in bf16

It writes one JSON: ``seeds`` (each seed's mAP per mode), ``config`` and
``summary`` (each mode's ``mean`` and ``per_seed``; ``delta_int8`` and
``delta_int8-fb`` against bf16 with ``mean``, ``per_seed`` and
``spread``). The data is ``tools/make_synthetic_voc.py``'s
(``data/synthetic.py:write_synthetic_voc(trainval_first=True)``), written
once under ``<root>/data`` with the same generation marker. A seed whose
checkpoint is on disk is not trained again, a mode whose ``result.txt``
is on disk not evaluated again. A failed CLI run raises and names its log.

    python -m odwscl_tpu_torch.tools.int8_accuracy_study [--seeds 1234 4321]
        [--iters 1000] [--n-train 128] [--n-test 64] [--img-h 192]
        [--img-w 256] [--n-props 300] [--root DIR] [--fallback-layers T]
        [--out FILE] [--device cuda|cpu] [KEY VALUE ...]

Trailing ``KEY VALUE`` pairs go to both CLIs after the study's own (a
CPU run takes narrow heads this way). Besides the JSON it prints, and
writes to ``<root>/timing.json``, the study's wall time, each seed's
median training step (``OUTPUT_DIR/logs/scalars.jsonl``) and each
evaluation's images/s (``inference/log.txt``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = ("bf16", "int8", "int8-fb")


def run(cmd, log_path):
    """``cmd`` with its output appended to ``log_path``; raises when it
    fails."""
    print("  $", " ".join(cmd), flush=True)
    with open(log_path, "ab") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            cwd=REPO).returncode
    if rc != 0:
        raise RuntimeError(f"{' '.join(cmd[2:4])} exited with {rc}; its "
                           f"output is in {log_path}")


def read_map(outdir):
    path = os.path.join(outdir, "inference", "voc_2007_test", "result.txt")
    with open(path) as f:
        txt = f.read()
    m = re.search(r"mAP[:=\s]+([0-9.]+)", txt)
    if not m:
        raise RuntimeError(f"no mAP in {path}:\n{txt[:400]}")
    return float(m.group(1))


def summarize(maps):
    """{mode: {mean, per_seed}} and {delta_<mode>: {mean, per_seed,
    spread}} of {seed: {mode: mAP}}."""
    summary = {}
    for mode in MODES:
        vals = [maps[s][mode] for s in maps]
        summary[mode] = {"mean": sum(vals) / len(vals), "per_seed": vals}
    for mode in ("int8", "int8-fb"):
        deltas = [maps[s][mode] - maps[s]["bf16"] for s in maps]
        summary[f"delta_{mode}"] = {
            "mean": sum(deltas) / len(deltas),
            "per_seed": deltas,
            "spread": max(deltas) - min(deltas)}
    return summary


def median_step_ms(train_dir):
    """The median of the run's per-iteration wall times, in ms."""
    with open(os.path.join(train_dir, "logs", "scalars.jsonl")) as f:
        steps = [json.loads(line)["time"] for line in f if line.strip()]
    return 1000.0 * statistics.median(steps)


def eval_images_per_s(mdir):
    """The last evaluation's images/s as ``test_net`` logged it."""
    with open(os.path.join(mdir, "inference", "log.txt")) as f:
        runs = re.findall(r"Inference: \d+ images in [0-9.]+s \(([0-9.]+) "
                          r"s/img\)", f.read())
    return 1.0 / float(runs[-1]) if runs and float(runs[-1]) > 0 else None


def write_data(args, data_root):
    """The JAX tool's synthetic VOC, once per size (its marker file)."""
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc

    marker = os.path.join(data_root, f".gen_{args.n_train}_{args.n_test}_"
                          f"{args.img_h}x{args.img_w}_{args.n_props}")
    if not os.path.exists(marker):
        shutil.rmtree(data_root, ignore_errors=True)
        write_synthetic_voc(data_root, n_test=args.n_test, seed=0,
                            img_hw=(args.img_h, args.img_w),
                            n_props=args.n_props, n_trainval=args.n_train,
                            trainval_first=True)
        open(marker, "w").close()


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1234, 4321])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--n-test", type=int, default=64)
    ap.add_argument("--img-h", type=int, default=192)
    ap.add_argument("--img-w", type=int, default=256)
    ap.add_argument("--n-props", type=int, default=300)
    ap.add_argument("--root",
                    default=os.path.join(tempfile.gettempdir(), "int8_study"))
    ap.add_argument("--fallback-layers", default="(4,5,6)",
                    help="TPU.INT8_BF16_LAYERS for the int8-fb mode")
    ap.add_argument("--out", default=None,
                    help="the JSON (default <root>/INT8_STUDY.json)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                    help="KEY VALUE pairs for both CLIs")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    root = os.path.abspath(args.root)
    out = args.out or os.path.join(root, "INT8_STUDY.json")
    data_root = os.path.join(root, "data")
    os.makedirs(root, exist_ok=True)
    write_data(args, data_root)

    cfg_file = os.path.join(REPO, "configs/voc/voc07_synth_smoke.yaml")
    common = [
        "INPUT.MIN_SIZE_TRAIN", f"({args.img_h - 32},)",
        "INPUT.MAX_SIZE_TRAIN", str(args.img_w),
        "INPUT.MIN_SIZE_TEST", str(args.img_h - 32),
        "INPUT.MAX_SIZE_TEST", str(args.img_w),
        "TPU.PROPOSAL_BUCKETS", "(512,)",
        "SOLVER.IMS_PER_BATCH", "4",
        "TEST.IMS_PER_BATCH", "4",
        "SOLVER.MAX_ITER", str(args.iters),
        "SOLVER.CHECKPOINT_PERIOD", str(args.iters),
        "SOLVER.STEPS", f"({int(args.iters * 0.7)},)",
        "SOLVER.WARMUP_ITERS", "50",
        "SOLVER.BASE_LR", "0.002",
    ] + list(args.opts or [])
    cli = [sys.executable, "-u", "-m"]
    where = ["--config-file", cfg_file, "--data-root", data_root,
             "--device", args.device]

    extra = {"bf16": [], "int8": ["--int8"],
             "int8-fb": ["--int8", "TPU.INT8_BF16_LAYERS",
                         args.fallback_layers]}
    results = {"seeds": {}, "config": {
        "n_train": args.n_train, "n_test": args.n_test,
        "iters": args.iters, "img_hw": [args.img_h, args.img_w],
        "n_props": args.n_props, "fallback_layers": args.fallback_layers,
        "tta": False,
    }}
    timing = {"seeds": {}}
    for seed in args.seeds:
        sdir = os.path.join(root, f"seed{seed}")
        log = os.path.join(root, f"seed{seed}.log")
        train_dir = os.path.join(sdir, "train")
        if not os.path.exists(os.path.join(
                train_dir, f"model_{args.iters:07d}.pt")):
            os.makedirs(train_dir, exist_ok=True)
            run(cli + ["odwscl_tpu_torch.tools.train_net", "--skip-test",
                       "--use-tensorboard"] + where +
                ["OUTPUT_DIR", train_dir, "SEED", str(seed)] + common, log)
        with open(os.path.join(train_dir, "last_checkpoint")) as f:
            ckpt = f.read().strip()
        if not os.path.isabs(ckpt):
            ckpt = os.path.join(train_dir, ckpt)
        per_mode, seed_timing = {}, {"median_step_ms": median_step_ms(
            train_dir)}
        for mode in MODES:
            mdir = os.path.join(sdir, f"eval_{mode}")
            if not os.path.exists(os.path.join(
                    mdir, "inference", "voc_2007_test", "result.txt")):
                shutil.rmtree(mdir, ignore_errors=True)
                os.makedirs(mdir)
                flags = [a for a in extra[mode] if a.startswith("--")]
                opts = [a for a in extra[mode] if not a.startswith("--")]
                run(cli + ["odwscl_tpu_torch.tools.test_net", "--ckpt", ckpt]
                    + flags + where + ["OUTPUT_DIR", mdir] + common + opts,
                    log)
            per_mode[mode] = read_map(mdir)
            seed_timing[f"{mode}_images_per_s"] = eval_images_per_s(mdir)
            print(f"seed {seed} {mode}: mAP {per_mode[mode]:.4f}",
                  flush=True)
        results["seeds"][str(seed)] = per_mode
        timing["seeds"][str(seed)] = seed_timing

    results["summary"] = summarize(results["seeds"])
    print(json.dumps(results["summary"], indent=1))
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out}")
    timing["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(root, "timing.json"), "w") as f:
        json.dump(timing, f, indent=1)
    print("[timing] " + json.dumps(timing))
    return results


if __name__ == "__main__":
    main()
