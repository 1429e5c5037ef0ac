"""Model FLOPs from the architecture: parameters in total and active a
token (a frozen copy of the program's ``ModelConfig.param_counts`` for
attention blocks with dense or expert FFNs, or the count of an
architecture's own ``model_<model_type>`` beside this module), and
6 N D / 2 N D."""
from __future__ import annotations

import math

from portbench.reference.arch import added


def padded_vocab(arch: dict) -> int:
    m = arch["vocab_pad_multiple"]
    return int(math.ceil(arch["vocab"] / m) * m)


def param_counts(arch: dict) -> dict:
    """{"total", "active"} parameters of ``arch`` (see
    ``reference.arch.from_config``): ``param_counts`` of the module
    ``model_<model_type>`` beside this one where the architecture adds
    it, else :func:`attention_counts`."""
    mod = added(__package__, "model", arch["model_type"])
    return (attention_counts if mod is None else mod.param_counts)(arch)


def attention_counts(arch: dict) -> dict:
    """{"total", "active"} of attention blocks: the embedding (twice when
    untied), attention's four projections, and the FFN, dense or the
    routed experts (``active`` counts the top-k experts a token takes)."""
    d, hd = arch["d_model"], arch["head_dim"]
    h, kv = arch["num_heads"], arch["num_kv_heads"]
    embed = padded_vocab(arch) * d * (1 if arch["tie_embeddings"] else 2)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    moe = arch.get("moe")
    if moe:
        expert = 3 * d * moe["expert_d_ff"]
        ffn_total = moe["num_experts"] * expert + d * moe["num_experts"]
        ffn_active = moe["experts_per_token"] * expert
    else:
        ffn_total = ffn_active = 3 * d * arch["d_ff"]
    n = arch["num_layers"]
    return {"total": embed + n * (attn + ffn_total),
            "active": embed + n * (attn + ffn_active)}


def train_flops(arch: dict, tokens: float) -> float:
    """6 N_active D: the model FLOPs of training on ``tokens``."""
    return 6.0 * param_counts(arch)["active"] * tokens


def forward_flops(arch: dict, tokens: float) -> float:
    """2 N_active D: the model FLOPs of a forward pass over ``tokens``."""
    return 2.0 * param_counts(arch)["active"] * tokens
