"""The device's idle time in the training step's forward: the traced
slice's idle gaps that began while `train.forward` was the innermost
program span, in ms per step (harness.spans)."""

UNIT = "ms"


def read(run):
    if run.mode != "train":
        return None
    from portbench.harness.spans import idle_ms
    return idle_ms(run, ("train.forward",), "train.step")
