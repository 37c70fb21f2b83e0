"""``train.data_wait_ms``: the mean wait of a training step for its batch,
by the harness's clock around each ``next()`` of the port's
``TrainLoader`` (decode, transform and collate not hidden behind the
previous step), in ms."""


def read(ctx):
    c = ctx["counts"]
    if c.get("kind") != "train" or not c["data_wait_s"]:
        return None
    waits = c["data_wait_s"][:c["steps"]]
    return 1e3 * sum(waits) / len(waits)
