"""Model FLOP utilisation of training: 3x the network forward's FLOPs (the
reference's count; forward and backward, no recomputation) for every clip of
every step in the untraced window, over its wall time, over the fp32 peak
(3xTF32, 165 TFLOP/s)."""

UNIT = "%"


def read(run):
    if run.mode != "train":
        return None
    from portbench.harness.shares import mfu
    return mfu(run, 3)
