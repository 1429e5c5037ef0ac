"""``train_tokens_per_s``, read the same way, for the device-bound expert
training cells: their runs spread a tenth as much as the host-bound dense
cell's, so they are held to a bound of their own."""
from portbench.harness import core

read = core.load_module(core.BENCH / "metrics" / "train_tokens_per_s.py").read
