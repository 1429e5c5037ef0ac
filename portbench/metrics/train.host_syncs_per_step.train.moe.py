"""``train.host_syncs_per_step.train``, read the same way, in the cells whose tokens a second
are ``train_tokens_per_s.moe``."""
from portbench.harness import core

read = core.load_module(core.BENCH / "metrics" / "train.host_syncs_per_step.train.py").read
