"""Cells of the manifest cut to a size the CPU runs in seconds, the same
code paths (the program's plain kernel versions)."""
from __future__ import annotations

import copy

from portbench.harness import core, portcfg
from portbench.reference.arch import from_config

#: The small widths, in each configuration file's own keys and the
#: program's fields: "tiny" for runs of seconds, "deep" (qwen2.5-3b at 8
#: layers of 512, heads of the published 128) where a lower precision's
#: error has to build up over depth as it does at full size.
SIZES = {
    "tiny": {
        "qwen2": ({"hidden_size": 64, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "intermediate_size": 128,
                   "vocab_size": 512, "num_hidden_layers": 2},
                  {"num_layers": 2, "d_model": 64, "num_heads": 4,
                   "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                   "vocab_size": 512}),
        "dbrx": ({"d_model": 64, "n_heads": 4, "vocab_size": 512,
                  "attn_config": {"kv_n_heads": 2, "rope_theta": 500000,
                                  "clip_qkv": None},
                  "ffn_config": {"ffn_hidden_size": 96, "moe_num_experts": 8,
                                 "moe_top_k": 2}},
                 {"num_layers": 1, "d_model": 64, "num_heads": 4,
                  "num_kv_heads": 2, "head_dim": 16, "d_ff": 96,
                  "vocab_size": 512}),
    },
    "deep": {
        "qwen2": ({"hidden_size": 512, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "intermediate_size": 1024,
                   "vocab_size": 4096, "num_hidden_layers": 8},
                  {"num_layers": 8, "d_model": 512, "num_heads": 4,
                   "num_kv_heads": 2, "head_dim": 128, "d_ff": 1024,
                   "vocab_size": 4096}),
        "dbrx": ({"d_model": 256, "n_heads": 2, "vocab_size": 512,
                  "attn_config": {"kv_n_heads": 1, "rope_theta": 500000,
                                  "clip_qkv": None},
                  "ffn_config": {"ffn_hidden_size": 256,
                                 "moe_num_experts": 8, "moe_top_k": 2}},
                 {"num_layers": 1, "d_model": 256, "num_heads": 2,
                  "num_kv_heads": 1, "head_dim": 128, "d_ff": 256,
                  "vocab_size": 512}),
    },
}
MIXES = {
    "train": {"rows": 4, "seq_len": 32, "microbatches": 2},
}


def small_cell(name: str, compute_dtype: str = "float32",
               size: str = "tiny"):
    """(cell, the program's config, the reference's arch) of manifest cell
    ``name`` at the ``size`` widths, computing in ``compute_dtype``."""
    c = core.cell(name)
    cfg = copy.deepcopy(c.config)
    hf, port = SIZES[size][cfg["model_type"]]
    cfg.update(copy.deepcopy(hf))
    cfg["semantics"].update(head_dim=port["head_dim"], vocab_pad_multiple=8,
                            compute_dtype=compute_dtype)
    moe = cfg["port"]["replace"].get("moe")
    cfg["port"]["replace"] = dict(cfg["port"]["replace"], **port,
                                  vocab_pad_multiple=8,
                                  compute_dtype=compute_dtype)
    if moe is not None:
        cfg["port"]["replace"]["moe"] = dict(
            moe, num_experts=8, experts_per_token=2,
            expert_d_ff=port["d_ff"])
        cfg["semantics"]["capacity_factor"] = 4.0
    mix = dict(copy.deepcopy(c.mix), **copy.deepcopy(MIXES[c.kind]))
    cell = core.Cell(c.name, cfg, mix, c.chips, c.end_to_end, c.per_layer)
    return cell, portcfg.build(cfg), from_config(cfg)
