"""Device kernels launched per network evaluation: the kernels in the traced
slice over the evaluations in it (memory copies and sets not counted)."""

UNIT = "kernels"


def read(run):
    if run.mode != "sample":
        return None
    from portbench.harness.shares import per_unit
    return per_unit(run, run.reading.n_kernels if run.reading else 0)
