"""Model FLOP utilisation of sampling: the network forward's FLOPs (the
reference's count) of every evaluation in the untraced window, over its wall
time, over the bf16 peak (989 TFLOP/s)."""

UNIT = "%"


def read(run):
    if run.mode != "sample":
        return None
    from portbench.harness.shares import mfu
    return mfu(run, 1)
