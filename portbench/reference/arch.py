"""A configuration file's published keys, read into one plain dict of the
sizes the reference needs. Each ``model_type`` has its reader.

An architecture is found by its ``model_type``: what a new one needs
beyond the shared code it brings as modules of its own, named
``<stem>_<model_type>`` (:func:`added`), and the shared code serves every
``model_type`` that brings none."""
from __future__ import annotations

import importlib


def _qwen2(c: dict) -> dict:
    return {"d_model": c["hidden_size"],
            "num_layers": c["num_hidden_layers"],
            "num_heads": c["num_attention_heads"],
            "num_kv_heads": c["num_key_value_heads"],
            "d_ff": c["intermediate_size"],
            "vocab": c["vocab_size"],
            "tie_embeddings": c["tie_word_embeddings"],
            "rope_theta": float(c["rope_theta"]),
            "moe": None}


def _dbrx(c: dict) -> dict:
    a, f = c["attn_config"], c["ffn_config"]
    return {"d_model": c["d_model"],
            "num_layers": c["n_layers"],
            "num_heads": c["n_heads"],
            "num_kv_heads": a["kv_n_heads"],
            "d_ff": f["ffn_hidden_size"],
            "vocab": c["vocab_size"],
            "tie_embeddings": c["tie_word_embeddings"],
            "rope_theta": float(a["rope_theta"]),
            "moe": {"num_experts": f["moe_num_experts"],
                    "experts_per_token": f["moe_top_k"],
                    "expert_d_ff": f["ffn_hidden_size"]}}


READERS = {"qwen2": _qwen2, "dbrx": _dbrx}


def added(package: str, stem: str, model_type: str):
    """The module ``<package>.<stem>_<model_type>`` that an architecture
    adds, or None where it adds none."""
    name = f"{package}.{stem}_{model_type}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def _reader(model_type: str):
    """The reader of a ``model_type``: one here, or ``read`` in the module
    ``arch_<model_type>`` beside this one."""
    if model_type in READERS:
        return READERS[model_type]
    mod = added(__package__, "arch", model_type)
    if mod is None:
        raise KeyError(f"no reader for model_type {model_type!r}: add "
                       f"{__package__}.arch_{model_type}")
    return mod.read


def reference_model(arch: dict):
    """The reference's ``Model`` class for ``arch``: ``Model`` of an added
    ``model_<model_type>`` beside this module, else the shared one of
    ``model.py`` (attention blocks with a gated MLP or routed experts)."""
    mod = added(__package__, "model", arch["model_type"])
    if mod is None:
        from . import model as mod
    return mod.Model


def from_config(c: dict) -> dict:
    """The architecture of configuration file ``c``: its published sizes
    and the numbers its ``semantics`` states."""
    arch = _reader(c["model_type"])(c)
    sem = c["semantics"]
    arch.update(model_type=c["model_type"], head_dim=sem["head_dim"],
                qkv_bias=sem["qkv_bias"], norm_eps=sem["norm_eps"],
                param_dtype=sem["param_dtype"],
                compute_dtype=sem["compute_dtype"],
                z_loss_weight=sem["z_loss_weight"],
                vocab_pad_multiple=sem["vocab_pad_multiple"])
    if arch["moe"] is not None:
        arch["moe"].update(capacity_factor=sem["capacity_factor"],
                           norm_topk=sem["router_norm_topk"],
                           aux_loss_weight=sem["aux_loss_weight"],
                           router_z_weight=sem["router_z_weight"])
    return arch
