"""Kernels a step: the kernels whose launch lies inside one of the train
step's phase regions (``train.forward``, ``train.backward``,
``train.accumulate``, ``optim.adamw``), over the steps traced."""
from portbench.harness import regions


def read(run):
    return regions.per_step(
        run, lambda t, ivs: len(regions.launched_within(t, ivs,
                                                        t.kernels())))
