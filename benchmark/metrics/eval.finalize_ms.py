"""``eval.finalize_ms``: the Inferencer's ``finalize_s`` (per-class NMS,
top-K and the transfer of the detections to the host, synchronized) per
TTA batch of the window, in ms."""


def read(ctx):
    c = ctx["counts"]
    if c.get("kind") != "eval" or not c["batches"]:
        return None
    return 1e3 * c["finalize_s"] / c["batches"]
