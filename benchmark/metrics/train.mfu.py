"""``train.mfu``: the FLOPs that the window's training steps need
(``flops.train_step_flops`` at each step's padded canvas and proposal
bucket) over the traced window's length at the card's dense bf16 peak,
in %."""

from benchmark import flops, peaks


def read(ctx):
    c, tr = ctx["counts"], ctx["trace"]
    if c.get("kind") != "train" or tr is None or not c["steps"]:
        return None
    total = sum(flops.train_step_flops(c["model"], shape[1:3], shape[0],
                                       boxes.shape[1])
                for shape, boxes, _ in c["shapes"])
    return 100.0 * total / (tr.window_s * peaks.rate(ctx["card"],
                                                     peaks.BF16_FLOPS))
