"""The end-to-end serve-path cell of the perf sweep (ROADMAP item).

The rest of the sweep drives the DMA runtime directly; this cell runs a
real :class:`repro_torch.serve.ServeEngine` — reduced model config, real
decode steps on the cell's device, §II-D writeback completions through
the control ring — and
gates the *continuous-batching* regressions the runtime cells cannot see:
admission stalls (requests queued behind full slots) and completion-poll
latency (decode steps between a request's writeback and the scheduler
observing it).

Determinism contract: every gated metric is a pure scheduling quantity —
admission and completion depend only on prompt lengths, ``max_new_tokens``
and the poll cadence, never on logits — so the cell regenerates
bit-for-bit from the sweep seed even though the decode math runs for real.
Wall-clock (``step_seconds``) is measured but never stored, exactly like
the runtime cells. The weights are drawn from the port's own generator
(the reference's ``PRNGKey(0)`` cannot be reproduced, and need not be:
no gated number reads a logit); the prompts come from the same numpy
generator as the reference's, so the cell equals the committed one.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.runtime import SubmitRequest
from repro_torch.runtime.instrumentation import PerfProbe


@dataclasses.dataclass(frozen=True)
class ServeCellSpec:
    """Fully determines the serve cell (and hence its baseline entry)."""

    arch: str = "qwen2.5-3b"   # reduced clone: the smallest decode path
    capacity: int = 2          # slots — kept below n_requests so admission
    n_requests: int = 6        # pressure (stalls) is actually exercised
    min_prompt: int = 2
    max_prompt: int = 6
    max_new_tokens: int = 4
    max_len: int = 32
    poll_every: int = 3        # decode steps between scheduler polls
    max_steps: int = 400       # safety valve; the cell drains far earlier

    @property
    def cell_key(self) -> str:
        return f"serve/{self.arch}/cap{self.capacity}"


DEFAULT_SERVE_SPEC = ServeCellSpec()

#: Gated serve-path metrics (all scheduling-deterministic; lower is better).
#: ``request_latency_steps`` is histogram-valued (schema v5): the gate
#: compares it at named percentiles with per-percentile tolerance, while
#: the p50/p99 scalars gate directly (DESIGN.md §8).
SERVE_GATED_METRICS = (
    "admission_stall_rate",
    "completion_poll_latency_steps",
    "serve_steps_per_request",
    "request_latency_steps_p50",
    "request_latency_steps_p99",
    "request_latency_steps",
)

_WALL_CLOCK_SERVE_COUNTERS = ("step_seconds",)


def run_serve_cell(
    seed: int,
    spec: ServeCellSpec = DEFAULT_SERVE_SPEC,
    *,
    device=None,
) -> Tuple[Dict[str, float], Dict[str, object]]:
    """Run the cell on ``device`` (``cuda`` unless given); returns
    ``(gated_metrics, stored_counters)``."""
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(spec.arch, reduced=True)
    params = init_params(0, cfg, device)
    probe = PerfProbe()
    eng = ServeEngine(params, cfg, capacity=spec.capacity,
                      max_len=spec.max_len, device=device)
    eng.attach_probe(probe)

    rng = np.random.default_rng(
        [seed, zlib.crc32(spec.cell_key.encode())])
    for uid in range(spec.n_requests):
        n_prompt = int(rng.integers(spec.min_prompt, spec.max_prompt + 1))
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, n_prompt)]
        eng.submit(SubmitRequest(request=Request(
            uid=uid, prompt=prompt, max_new_tokens=spec.max_new_tokens)))

    while ((eng.queue or any(s.busy for s in eng.slots))
           and eng.steps < spec.max_steps):
        eng.step()
        if eng.steps % spec.poll_every == 0:
            eng.poll_completed()
    delivered = eng.poll_completed()

    if len(delivered) != spec.n_requests:
        raise RuntimeError(
            f"serve cell did not drain: {len(delivered)}/{spec.n_requests} "
            f"requests delivered in {eng.steps} steps — the cell would "
            "gate garbage")

    pc = eng.perf_counters()
    metrics = {
        "admission_stall_rate": float(pc["serve.admission_stall_rate"]),
        "completion_poll_latency_steps":
            float(pc["serve.completion_poll_latency_steps"]),
        "serve_steps_per_request":
            float(pc["serve.steps"] / spec.n_requests),
        # Tail latency (schema v5): end-to-end submit -> §II-D writeback in
        # decode steps. Steps are pure scheduling outcomes, so the whole
        # histogram (and hence its percentiles) regenerates bit-for-bit;
        # small-integer samples land in the width-1 linear buckets, making
        # p50/p99 *exact*, not bucket-floor approximations.
        "request_latency_steps_p50":
            float(pc["serve.request_latency_steps_p50"]),
        "request_latency_steps_p99":
            float(pc["serve.request_latency_steps_p99"]),
        "request_latency_steps": dict(pc["serve.request_latency_steps"]),
    }
    serve_counters = {
        k: v for k, v in dataclasses.asdict(probe.serve).items()
        if k not in _WALL_CLOCK_SERVE_COUNTERS
    }
    counters = {
        "serve": serve_counters,
        "speculation_depth": float(pc["serve.speculation_depth"]),
        # Deterministic translation-cache traffic of the engine's runtime
        # (event counts only — no wall clock). Stored raw (bare keys): the
        # document layout is schema-versioned, not deprecation-aliased.
        "translation_cache": eng.runtime._translation_stats_raw(),
    }
    return metrics, counters
