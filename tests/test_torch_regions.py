"""The train step's regions (``repro_torch.obs.trace.region``) under
``torch.profiler``, on the CPU: each named where the step opens it and as
often, the step's result unchanged by the profiler, a profiler started
between a forward and its backward harmless under remat "minimal"'s
selective recompute, and nothing built while the profiler is off.

The reduced qwen2.5-3b (2 periods) trains on a batch of 2 rows in 2
microbatches, so a step opens ``train.forward`` and ``train.backward``
twice, ``train.accumulate`` four times (the fp32 zeros, each sum, the
divide), ``optim.adamw`` once and ``model.recompute`` once a recomputed
period a microbatch.
"""
import collections
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.train import TrainConfig, init_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

REGIONS = ("train.forward", "train.backward", "train.accumulate",
           "optim.adamw", "model.recompute")


def _cfg(remat="minimal"):
    return dataclasses.replace(get_config("qwen2.5-3b", reduced=True),
                               remat_policy=remat)


def _batch(vocab, seed=3):
    out = make_batch(DataConfig(vocab_size=vocab, seq_len=32, global_batch=2,
                                seed=seed, mean_doc_len=16), 0)
    return {k: torch.as_tensor(out[k]) for k in ("tokens", "labels",
                                                 "loss_mask")}


def _step(cfg, microbatches=2):
    tcfg = TrainConfig(optimizer=optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                   total_steps=4),
                       microbatches=microbatches)
    return (init_state(init_params(0, cfg, "cpu"), tcfg),
            make_train_step(cfg, tcfg))


def _counts(prof, tmp_path):
    """How often each region appears in the profiler's Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return collections.Counter(e["name"] for e in events
                               if e.get("ph") == "X" and e["name"] in REGIONS)


@pytest.mark.parametrize("remat,microbatches", [
    ("minimal", 2), ("full", 2), ("none", 2), ("minimal", 1)])
def test_each_region_opens_where_and_as_often_as_named(remat, microbatches,
                                                       tmp_path):
    cfg = _cfg(remat)
    state, step = _step(cfg, microbatches)
    batch = _batch(cfg.vocab_size)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    recomputed = 0 if remat == "none" else cfg.num_periods * microbatches
    assert _counts(prof, tmp_path) == collections.Counter({
        "train.forward": microbatches, "train.backward": microbatches,
        "train.accumulate": microbatches + 2 if microbatches > 1 else 0,
        "optim.adamw": 1, "model.recompute": recomputed})


def test_traced_step_leaves_the_state_bit_identical():
    cfg = _cfg()
    batch = _batch(cfg.vocab_size)
    plain, step = _step(cfg)
    traced, _ = _step(cfg)
    plain, m0 = step(plain, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, m1 = step(traced, batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in ((plain.params, traced.params), (plain.opt.m, traced.opt.m),
                 (plain.opt.v, traced.opt.v)):
        a, b = flatten(a), flatten(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _grads(params, batch, cfg, profile_backward, tmp_path=None):
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = loss_fn(tree, batch, cfg)
    leaves = list(flatten(tree).values())
    if not profile_backward:
        return torch.autograd.grad(loss, leaves, allow_unused=True), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return grads, _counts(prof, tmp_path)


def test_profiler_started_between_forward_and_backward(tmp_path):
    """The recompute opens a region the forward never did: a dispatched
    span there would make the selective checkpoint's backward raise."""
    cfg = _cfg("minimal")
    params = init_params(0, cfg, "cpu")
    batch = _batch(cfg.vocab_size)
    want, _ = _grads(params, batch, cfg, False)
    got, counts = _grads(params, batch, cfg, True, tmp_path)
    assert counts["model.recompute"] == cfg.num_periods
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_region_off_is_the_shared_null_context(monkeypatch):
    built = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        built.append(name)
        return real(name)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    assert trace.region("train.forward") is trace.region("optim.adamw")
    cfg = _cfg()
    state, step = _step(cfg)
    batch = _batch(cfg.vocab_size)
    step(state, batch)
    assert built == []
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.region("probe"):
            pass
        step(state, batch)
    assert built.count("probe") == 1 and built.count("optim.adamw") == 1
