"""The share of the traced window in which the device idled while the
program's ``model.recompute`` regions were open (each period recomputed
in the backward, on autograd's thread): 100 x that idle time / the
window. It is part of ``train.backward_idle_share.train``."""
from portbench.harness import regions


def read(run):
    return regions.idle_share(run, regions.RECOMPUTE)
