"""The share of the traced window in which the device idled while the
program's ``train.forward`` regions were open (the parameter cast and the
loss, once a microbatch): 100 x that idle time / the window."""
from portbench.harness import regions


def read(run):
    return regions.idle_share(run, "train.forward")
