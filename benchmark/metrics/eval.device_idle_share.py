"""``eval.device_idle_share``: the share of the traced eval window in
which no kernel, copy or fill ran on the device (the union of their
intervals), in %."""


def read(ctx):
    c, tr = ctx["counts"], ctx["trace"]
    if c.get("kind") != "eval" or tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
