"""The fp32 microbatch sums' share of the device time in the traced steps:
the device time of the operations launched inside the program's
``train.accumulate`` regions over that of every device operation (the
twin of ``optim.adamw_share.train``)."""
from portbench.harness import regions


def read(run):
    t = regions.train_trace(run)
    ivs = regions.intervals(t, "train.accumulate") if t is not None else []
    total = sum(o.dur for o in t.device) if ivs else 0.0
    if not total:
        return None
    acc = sum(o.dur for o in regions.launched_within(t, ivs, t.device))
    return 100.0 * acc / total
