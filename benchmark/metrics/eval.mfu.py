"""``eval.mfu``: the FLOPs of the window's TTA forwards
(``flops.eval_forward_flops`` at each of a batch's 14 canvases) over the
traced window's length at the card's dense bf16 peak, in %."""

from benchmark import flops, peaks


def read(ctx):
    c, tr = ctx["counts"], ctx["trace"]
    if c.get("kind") != "eval" or tr is None or not c["batches"]:
        return None
    total = sum(flops.eval_forward_flops(c["model"], hw, c["batch"],
                                         c["rois"])
                for per in c["canvases"] for hw in per)
    return 100.0 * total / (tr.window_s * peaks.rate(ctx["card"],
                                                     peaks.BF16_FLOPS))
