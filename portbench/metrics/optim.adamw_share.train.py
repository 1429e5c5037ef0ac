"""AdamW's share of the device time in the traced steps: the device time
of the operations launched inside the program's optimizer update (the
``optim.apply`` span) over that of every device operation."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    total = sum(o.dur for o in t.device)
    adamw = sum(o.dur for o in t.launched_in("optim.apply"))
    if not total or not adamw:
        return None
    return 100.0 * adamw / total
