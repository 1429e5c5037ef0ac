"""The share of the traced window in which the device idled while the
program's ``train.backward`` regions were open (``torch.autograd.grad``,
once a microbatch; the recompute lies inside): 100 x that idle time / the
window."""
from portbench.harness import regions


def read(run):
    return regions.idle_share(run, "train.backward")
