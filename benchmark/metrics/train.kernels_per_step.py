"""``train.kernels_per_step``: device kernels launched in the traced
window per training step (the per-class loops of mining, pseudo-labels
and refinement launch most of them)."""


def read(ctx):
    c, tr = ctx["counts"], ctx["trace"]
    if c.get("kind") != "train" or tr is None or not c["steps"]:
        return None
    return tr.kernels / c["steps"]
