"""The frozen reference against the program's CPU path (plain PyTorch on
both sides) at small widths in float32, so that a wrong reference is
caught before the chip; and the program's configuration against the
published sizes the reference reads."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench.harness import core, portcfg, weights
from portbench.harness.traffic import TrainFeed
from portbench.reference import train as ref_train
from portbench.reference.arch import from_config
from portbench.reference.model import Model
from portbench.tests.small import small_cell

CELLS = ("qwen2.5-3b.train", "dbrx-132b.train")
CPU = torch.device("cpu")


def fp32_cell(name):
    """The small cell with fp32 parameters and compute: both sides exact
    to rounding."""
    cell, cfg, arch = small_cell(name, "float32")
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    return cell, cfg, dict(arch, param_dtype="float32")


@pytest.mark.parametrize("name", [w["name"] for w in core.manifest()[
    "workloads"]])
def test_program_config_is_the_published_one(name):
    cell = core.cell(name)
    cfg, arch = portcfg.build(cell.config), from_config(cell.config)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim_, cfg.vocab_size, cfg.tie_embeddings,
            cfg.qkv_bias, cfg.rope_theta, cfg.norm_eps, cfg.param_dtype,
            cfg.compute_dtype, cfg.vocab_pad_multiple) == (
        arch["num_layers"], arch["d_model"], arch["num_heads"],
        arch["num_kv_heads"], arch["head_dim"], arch["vocab"],
        arch["tie_embeddings"], arch["qkv_bias"], arch["rope_theta"],
        arch["norm_eps"], arch["param_dtype"], arch["compute_dtype"],
        arch["vocab_pad_multiple"])
    if arch["moe"] is None:
        assert cfg.moe is None and cfg.d_ff == arch["d_ff"]
    else:
        m, a = cfg.moe, arch["moe"]
        assert (m.num_experts, m.experts_per_token, m.expert_d_ff,
                m.capacity_factor, m.router_norm_topk, m.aux_loss_weight,
                m.router_z_weight) == (
            a["num_experts"], a["experts_per_token"], a["expert_d_ff"],
            a["capacity_factor"], a["norm_topk"], a["aux_loss_weight"],
            a["router_z_weight"])


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_every_gradient(name):
    from repro_torch.train import grads_and_metrics
    from repro_torch.tree import flatten
    cell, cfg, arch = fp32_cell(name)
    shapes = portcfg.leaf_shapes(cfg)
    feed = TrainFeed(cell.mix, arch["vocab"], 11, CPU)
    got, m = grads_and_metrics(portcfg.tree(cfg, weights.draw(11, shapes, CPU)),
                               feed.batch(0), cfg, cell.mix["microbatches"])
    loss, want = ref_train.grads(arch, weights.draw(11, shapes, CPU),
                                 feed.microbatches(0), "fp32")
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-6)
    got = flatten(got)
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.allclose(got[k], w, rtol=1e-4, atol=1e-6 * float(
            w.abs().max()) + 1e-9), k


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_adamw_update(dtype):
    """Two updates from the same gradients: the reference's AdamW (global
    clipping, decoupled decay, fp32 moments, a bf16 parameter rounded
    back) against the program's."""
    from repro_torch import optim
    o = core.cell("qwen2.5-3b.train").mix["optimizer"]
    ocfg = optim.AdamWConfig(
        lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
        weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
        schedule=o["schedule"], warmup_steps=o["warmup_steps"])
    gen = torch.Generator().manual_seed(1)
    shapes = {"a": (64, 32), "b": (32,), "c": (3, 16, 8)}
    start = {k: (0.05 * torch.randn(s, generator=gen)).to(dtype)
             for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen) * 0.3 for k, s in
              shapes.items()} for _ in range(2)]
    params = {k: v.clone() for k, v in start.items()}
    state = optim.init(params)
    P = {k: v.clone() for k, v in start.items()}
    m = {k: torch.zeros(s) for k, s in shapes.items()}
    v = {k: torch.zeros(s) for k, s in shapes.items()}
    for i, g in enumerate(grads):
        params, state, _ = optim.apply(
            ocfg, params, {k: x.to(dtype) for k, x in g.items()}, state)
        ref_train.adamw(o, P, {k: x.to(dtype).float() for k, x in
                               g.items()}, m, v, i + 1)
    for k in shapes:
        assert torch.allclose(params[k].float(), P[k].float(), rtol=1e-5,
                              atol=1e-7 if dtype == torch.float32
                              else 2e-3 * float(P[k].abs().max())), k
        assert torch.allclose(state.m[k], m[k], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", CELLS)
def test_logits_of_the_forward(name):
    """The forward serving's check reads, for each configuration."""
    from repro_torch.models import forward
    cell, cfg, arch = fp32_cell(name)
    shapes = portcfg.leaf_shapes(cfg)
    tok = torch.randint(0, arch["vocab"], (2, 24),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = forward(portcfg.tree(cfg, weights.draw(3, shapes, CPU)),
                      {"tokens": tok}, cfg)[0]
        want = Model(arch, weights.draw(3, shapes, CPU)).logits(tok)[0]
    assert torch.allclose(got.float(), want, rtol=1e-4, atol=1e-5)


def test_weights_redraw_a_group_to_the_bit():
    _, cfg, _ = small_cell("dbrx-132b.train")
    shapes = portcfg.leaf_shapes(cfg)
    whole = weights.draw(2 ** 33 + 1, shapes, CPU)
    for g in weights.groups(shapes):
        for k, v in weights.draw_group(2 ** 33 + 1, g, shapes, CPU).items():
            assert torch.equal(v, whole[k]) and v.dtype == shapes[k][1]
    other = weights.draw(2 ** 33 + 2, shapes, CPU)
    assert not torch.equal(other["embed/embedding"], whole["embed/embedding"])
    assert float(whole["final_norm/scale"].abs().max()) == 0.0
