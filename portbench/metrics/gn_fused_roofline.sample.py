"""`gn_fused`'s share of its roofline in sampling (see harness.shares.roofline
and counts/gn_fused.py)."""

UNIT = "%"


def read(run):
    if run.mode != "sample":
        return None
    from portbench.harness.shares import roofline
    return roofline(run, "gn_fused")
