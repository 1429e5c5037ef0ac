"""Port parity: the serve engine, its trace recorder and the serve launcher.

The port's ``ServeEngine`` and the reference's serve the same requests
with the same weights (the reference's, through ``params_from_jax``) in
fp32 compute, so greedy tokens do not flip on bf16 rounding: completion
order, the ``serve.*`` counters (all but the wall clock), the request
latency histogram and every request's greedy output must be identical.
The archs cover every kind of decode cache: K/V (qwen2.5-3b), MoE
(dbrx-132b), MLA's latent (deepseek-v2-236b), Mamba's conv and state
(mamba2-780m), both in one period (jamba-v0.1-52b), and an
encoder-decoder, whose engines both decode without encoder memory
(seamless-m4t-medium). Everything runs on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.runtime import SubmitRequest as JSubmitRequest  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import init_params, params_from_jax  # noqa: E402
from repro_torch.obs.export import write_chrome_trace  # noqa: E402
from repro_torch.obs.record import record_serve_trace  # noqa: E402
from repro_torch.runtime import SubmitRequest, default_runtime  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402


def _requests(seed, n, vocab=512):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        prompt = [int(t) for t in rng.integers(1, vocab,
                                               int(rng.integers(2, 9)))]
        out.append((uid, prompt, int(rng.integers(2, 6))))
    return out


def _drive(eng, submit_request, request, reqs, poll_every=3):
    for uid, prompt, new in reqs:
        eng.submit(submit_request(request=request(
            uid=uid, prompt=list(prompt), max_new_tokens=new)))
    order = []
    while (eng.queue or any(s.busy for s in eng.slots)) and eng.steps < 400:
        eng.step()
        if eng.steps % poll_every == 0:
            order.extend(r.uid for r in eng.poll_completed()
                         if r.uid not in order)
    order.extend(r.uid for r in eng.poll_completed() if r.uid not in order)
    pc = dict(eng.perf_counters())
    pc.pop("serve.step_seconds")
    return order, list(eng.completed), pc, {
        uid: list(r.output) for uid, r in eng.completed.items()}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b",
                                  "deepseek-v2-236b", "mamba2-780m",
                                  "jamba-v0.1-52b", "seamless-m4t-medium"])
def test_engine_matches_the_reference_engine(arch):
    jcfg, tcfg = (dataclasses.replace(get(arch, reduced=True),
                                      compute_dtype="float32")
                  for get in (jget_config, get_config))
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    reqs = _requests(7, 7)
    want = _drive(JServeEngine(jp, jcfg, capacity=3, max_len=24),
                  JSubmitRequest, JRequest, reqs)
    got = _drive(ServeEngine(tp, tcfg, capacity=3, max_len=24,
                             device="cpu"),
                 SubmitRequest, Request, reqs)
    delivered, completed, counters, outputs = got
    assert delivered == want[0] and completed == want[1]
    assert sorted(completed) == list(range(7))
    assert counters == want[2]
    assert counters["serve.request_latency_steps"]["n"] == 7
    assert outputs == want[3]
    # max_len 24 cuts no request short: each got what it asked for.
    assert all(len(outputs[uid]) == new for uid, _, new in reqs)


def test_engine_rejects_runtime_without_completion_channel():
    # Validation fires before any model state is built, so params/cfg can
    # be inert placeholders.
    with pytest.raises(ValueError, match="control-tier channel"):
        ServeEngine(params=None, cfg=None, device="cpu",
                    runtime=default_runtime(2, tier="serial", max_len=8,
                                            device="cpu"))


def test_engine_refuses_the_legacy_submit_and_unported_models():
    cfg = get_config("qwen2.5-3b", reduced=True)
    eng = ServeEngine(init_params(0, cfg, "cpu"), cfg, capacity=1,
                      max_len=8, device="cpu")
    with pytest.raises(TypeError, match="SubmitRequest"):
        eng.submit(Request(uid=0, prompt=[1, 2]))
    with pytest.raises(ValueError, match="SubmitRequest.request"):
        eng.submit(SubmitRequest())
    ticket = eng.submit(SubmitRequest(request=Request(uid=5, prompt=[3])))
    assert ticket.uid == 5 and ticket.channel == "completion"
    # Every arch builds an engine: mamba2-780m with one MambaCache per
    # slot, seamless-m4t-medium without cross-attention caches (its
    # decode runs without encoder memory, as the reference's engine's).
    mamba = ServeEngine({}, get_config("mamba2-780m", reduced=True),
                        capacity=2, max_len=8, device="cpu")
    (slot,) = mamba.state.caches["slots"]
    assert type(slot).__name__ == "MambaCache" and slot.state.shape[1] == 2
    slot.state.fill_(1.0)
    slot.conv.fill_(1.0)
    mamba._reset_slot_caches(1)
    assert bool((slot.state[:, 0] == 1).all()) and not slot.state[:, 1].any()
    assert not slot.conv[:, 1].any()
    seamless = ServeEngine({}, get_config("seamless-m4t-medium",
                                          reduced=True),
                           capacity=1, max_len=8, device="cpu")
    assert set(seamless.state.caches) == {"prefix", "slots"}


def test_engine_runs_on_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2.5-3b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServeEngine({}, cfg, capacity=1, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        launch_serve.main(["--arch", "qwen2.5-3b", "--reduced"])


def test_recorded_serve_trace_covers_every_lifecycle_phase(tmp_path):
    tracer, probe, pc = record_serve_trace(0, mesh=1, device="cpu")
    evs = tracer.events()
    names = {e.name for e in evs}
    assert {"request", "request.submit", "serve.step", "writeback",
            "delivered", "payload"} <= names
    begins = {e.id for e in evs if e.ph == "b" and e.name == "request"}
    ends = {e.id for e in evs if e.ph == "e" and e.name == "request"}
    assert begins == ends and len(begins) == 6
    assert {e.track for e in evs if e.clock == "cycle"} == \
        {"sim/ch0", "sim/ch1"}
    assert all(e.clock == "wall" for e in evs
               if not e.track.startswith("sim/"))
    doc = write_chrome_trace(str(tmp_path / "serve.trace.json"), evs)
    assert json.loads((tmp_path / "serve.trace.json").read_text()) == doc
    assert probe.metrics_snapshot()["request_latency_steps"]["n"] == 6
    assert pc["serve.request_latency_steps_p50"] > 0
    # mesh >= 2 records the sharded serve path (tests/test_torch_sharded.py
    # holds it against the reference's recorder).
    tracer, _, pc = record_serve_trace(0, mesh=2, device="cpu")
    assert pc["sharded.completed"] == 6
    assert {"migrate.egress", "migrate.ingress", "hop"} <= \
        {e.name for e in tracer.events()}


def test_serve_launcher_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen2.5-3b", "--reduced",
                              "--requests", "3", "--max-new-tokens", "4",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("3/3 requests, 12 tokens,")
    assert "on cpu" in out
    assert out.count("  req ") == 3
