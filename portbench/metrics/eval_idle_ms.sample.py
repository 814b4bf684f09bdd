"""The device's idle time inside the sampler's network evaluations: the
traced slice's idle gaps that began while `sample.eval` was the innermost
program span, in ms per evaluation (harness.spans)."""

UNIT = "ms"


def read(run):
    if run.mode != "sample":
        return None
    from portbench.harness.spans import idle_ms
    return idle_ms(run, ("sample.eval",), "sample.eval")
