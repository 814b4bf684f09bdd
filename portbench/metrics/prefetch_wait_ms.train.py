"""The training loop's wait on the data layer, timed where it happens: the
mean duration of the `data.wait` spans (`prefetch_to_device`'s consumer
blocked on its queue) in the traced slice, in ms per batch (harness.spans;
cells that feed from the device read nothing)."""

UNIT = "ms"


def read(run):
    if run.mode != "train":
        return None
    from portbench.harness.spans import mean_ms
    return mean_ms(run, "data.wait")
