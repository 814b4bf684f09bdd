"""The device's idle share in the untraced window: 1 - busy / wall, its busy
time the union of the device's activity intervals (kernels, copies, sets) an
evaluation in the traced slice, times the window's evaluations (harness.shares.idle)."""

UNIT = "%"


def read(run):
    if run.mode != "sample":
        return None
    from portbench.harness.shares import idle
    return idle(run)
