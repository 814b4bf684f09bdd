"""The device's idle time at the sampler's block edges and between its
evaluations: the traced slice's idle gaps that began inside `sample.block`
or `sample.request` but outside every `sample.eval` (the chain's update,
the weights' casts, the cond slide and `cat`, the next block's draws), in
ms per block (harness.spans)."""

UNIT = "ms"


def read(run):
    if run.mode != "sample":
        return None
    from portbench.harness.spans import idle_ms
    return idle_ms(run, ("sample.block", "sample.request"), "sample.block")
