"""The device's idle time in the training step's backward: the traced
slice's idle gaps that began while `train.backward` was the innermost
program span (the main thread waits there while autograd's thread issues
the backward's kernels), in ms per step (harness.spans)."""

UNIT = "ms"


def read(run):
    if run.mode != "train":
        return None
    from portbench.harness.spans import idle_ms
    return idle_ms(run, ("train.backward",), "train.step")
