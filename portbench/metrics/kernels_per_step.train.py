"""Device kernels launched per training step: the kernels in the traced
slice over the steps in it (memory copies and sets not counted)."""

UNIT = "kernels"


def read(run):
    if run.mode != "train":
        return None
    from portbench.harness.shares import per_unit
    return per_unit(run, run.reading.n_kernels if run.reading else 0)
