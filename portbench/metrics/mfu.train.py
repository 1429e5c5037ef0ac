"""The whole training step's share of the chip's peak: 6 N_active D (the
frozen count, D every token trained in the window) over the dense bf16
peak times the window's seconds."""
from portbench.counts import model, peaks


def read(run):
    if run.kind != "train" or not run.window_s:
        return None
    return 100.0 * model.train_flops(run.arch, run.counts["tokens"]) \
        / (peaks.BF16_FLOPS * run.window_s)
