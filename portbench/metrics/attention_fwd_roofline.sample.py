"""`attention_fwd`'s share of its roofline in sampling (see harness.shares.roofline
and counts/attention_fwd.py)."""

UNIT = "%"


def read(run):
    if run.mode != "sample":
        return None
    from portbench.harness.shares import roofline
    return roofline(run, "attention_fwd")
