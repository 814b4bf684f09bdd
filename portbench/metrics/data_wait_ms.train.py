"""The training loop's wait on the data layer: the host clock around `next()`
on `prefetch_to_device`'s iterator, mean per step over the untraced window
(cells that feed from the device read nothing)."""

UNIT = "ms"


def read(run):
    if run.mode != "train":
        return None
    return run.outcome.extra.get("data_wait_ms")
