"""Cells of the manifest cut to a size the CPU runs in seconds, the same
code paths (the program's plain kernel versions)."""
from __future__ import annotations

import copy

from portbench.harness import core, portcfg
from portbench.reference.arch import added, from_config

#: The small widths by size and ``model_type``, each a pair: the
#: configuration file's own keys (a nested group replaced whole), and the
#: program's fields, where ``moe`` holds the expert group's own sizes.
#: "tiny" for runs of seconds, "deep" (qwen2.5-3b at 8 layers of 512,
#: heads of the published 128) where a lower precision's error has to
#: build up over depth as it does at full size. Another ``model_type``
#: brings its pairs by size as ``SIZES`` in ``sizes_<model_type>.py``
#: beside this module.
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
                  "vocab_size": 512,
                  "moe": {"num_experts": 8, "experts_per_token": 2,
                          "expert_d_ff": 96}}),
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
                  "vocab_size": 512,
                  "moe": {"num_experts": 8, "experts_per_token": 2,
                          "expert_d_ff": 256}}),
    },
}
MIXES = {
    "train": {"rows": 4, "seq_len": 32, "microbatches": 2},
}


def sizes(model_type: str) -> dict:
    """The small widths of ``model_type`` by size: ``SIZES`` of an added
    ``sizes_<model_type>.py``, else this module's."""
    mod = added(__package__, "sizes", model_type)
    if mod is not None:
        return mod.SIZES
    return {size: by_type[model_type] for size, by_type in SIZES.items()}


def small_cell(name: str, compute_dtype: str = "float32",
               size: str = "tiny"):
    """(cell, the program's config, the reference's arch) of manifest cell
    ``name`` at the ``size`` widths, computing in ``compute_dtype``."""
    c = core.cell(name)
    cfg = copy.deepcopy(c.config)
    hf, port = copy.deepcopy(sizes(cfg["model_type"])[size])
    cfg.update(hf)
    cfg["semantics"].update(head_dim=port["head_dim"], vocab_pad_multiple=8,
                            compute_dtype=compute_dtype)
    moe = cfg["port"]["replace"].get("moe")
    experts = port.pop("moe", None)
    cfg["port"]["replace"] = dict(cfg["port"]["replace"], **port,
                                  vocab_pad_multiple=8,
                                  compute_dtype=compute_dtype)
    if moe is not None:
        assert experts is not None, f"no expert sizes for {name} at {size}"
        # Dropless at the small sizes unless the sizes say otherwise.
        group = dict(moe, capacity_factor=experts["num_experts"]
                     / experts["experts_per_token"])
        group.update(experts)
        cfg["port"]["replace"]["moe"] = group
        cfg["semantics"]["capacity_factor"] = group["capacity_factor"]
    mix = dict(copy.deepcopy(c.mix), **copy.deepcopy(MIXES[c.kind]))
    cell = core.Cell(c.name, cfg, mix, c.chips, c.end_to_end, c.per_layer)
    return cell, portcfg.build(cfg), from_config(cfg)
