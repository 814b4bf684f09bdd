"""`gn_fused_bwd`'s share of its roofline in training (see harness.shares.roofline
and counts/gn_fused_bwd.py)."""

UNIT = "%"


def read(run):
    if run.mode != "train":
        return None
    from portbench.harness.shares import roofline
    return roofline(run, "gn_fused_bwd")
