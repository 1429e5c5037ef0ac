"""The share of the traced window in which no operation ran on the
device: 1 - (union of the device operations' intervals) / window."""
from portbench.harness import trace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.end <= t.start:
        return None
    return 100.0 * (1.0 - trace.union_us(t.device, t.start, t.end)
                    / (t.end - t.start))
