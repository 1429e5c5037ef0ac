"""``mfu.train``, read the same way, in the cells whose tokens a second
are ``train_tokens_per_s.moe`` (the device-bound expert training cells,
held to a bound of their own)."""
from portbench.harness import core

read = core.load_module(core.BENCH / "metrics" / "mfu.train.py").read
