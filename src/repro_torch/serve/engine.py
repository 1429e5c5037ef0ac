"""Continuous-batching serving engine.

Fixed-capacity slot model: every engine step decodes one token for each
occupied slot (prompt tokens are teacher-forced through the same path —
"prefill-as-decode"), new requests are admitted into free slots between
steps, and completions are signalled by the paper's writeback convention:
each request owns a control descriptor in a :mod:`repro_torch.runtime`
channel ring whose first-8-bytes all-ones flag the scheduler polls (§II-D).
All descriptor work in the serve path goes through the runtime — the
engine never calls ``execute_*`` directly (DESIGN.md §3).

The engine runs on ``device`` (``cuda`` unless the caller passes ``cpu``):
its decode caches are allocated there once and written in place. A step
runs the decode over every slot, busy or not, as the reference does;
what a free slot writes is invalidated when a request is admitted to it,
by clearing its position tags. ``cur_pos`` is kept on the host as well,
so a step moves one array to the device (the tokens and positions) and
one back (the sampled tokens).

Every arch the reference's engine takes runs here: attention caches,
MLA's latent caches and Mamba's conv/state caches, cleared row by row on
admission. For an encoder-decoder the engine, like the reference's, builds
its caches without encoder memory, so its decode skips cross-attention.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import DecodeState, decode_step
from repro_torch.models.transformer import init_decode_caches
from repro_torch.obs.counters import PerfCounters, namespaced
from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import Tracer, monotonic
from repro_torch.runtime import ChannelConfig, DMARuntime
from repro_torch.runtime.instrumentation import PerfProbe
from repro_torch.runtime.submit import (
    SubmitRequest,
    Ticket,
    reject_legacy_submit,
)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # Global KV page ids the request reads (sharded serving routes by
    # them — DESIGN.md §6); the single-device engine carries them along.
    kv_pages: Optional[List[int]] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    prompt_cursor: int = 0

    @property
    def busy(self) -> bool:
        return self.request is not None


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, capacity: int = 4,
                 max_len: int = 128, greedy: bool = True,
                 runtime: Optional[DMARuntime] = None,
                 completion_ring: int = 256, device=None):
        self.params, self.cfg = params, cfg
        self.capacity, self.max_len = capacity, max_len
        self.greedy = greedy
        self.device = resolve_device(device)
        self.queue: deque[Request] = deque()
        self.slots = [_Slot() for _ in range(capacity)]
        self.completed: Dict[int, Request] = {}
        # Completion channel: one control descriptor per request, living in
        # a submission ring; the step loop performs the §II-D writeback on
        # finish and poll_completed observes it through the ring.
        self.runtime = runtime or DMARuntime(
            [ChannelConfig(name="completion", tier="control",
                           ring_capacity=completion_ring)],
            device=self.device)
        self._completion_channel = "completion"
        ch = self.runtime.channels.get(self._completion_channel)
        if ch is None or ch.cfg.tier != "control":
            raise ValueError(
                "runtime must provide a control-tier channel named "
                f"'{self._completion_channel}' for request completions")
        self._tickets: Dict[int, int] = {}        # uid -> ring ticket
        self._ticket_uid: Dict[int, int] = {}     # ring ticket -> uid
        self._delivered: Dict[int, Request] = {}  # completion-event'd uids
        self._completed_at: Dict[int, int] = {}   # uid -> step of writeback
        self._submitted_at: Dict[int, int] = {}   # uid -> step of submit
        # End-to-end request latency (submit -> §II-D writeback) in decode
        # steps: deterministic under a fixed seed, so its p50/p99 are gated
        # per serve cell. Small-integer domain -> the width-1 linear
        # buckets make the percentiles exact (DESIGN.md §8).
        self.request_latency = Histogram()
        caches = init_decode_caches(cfg, capacity, max_len,
                                    device=self.device)
        self._cur = np.zeros((capacity,), np.int32)   # host copy of cur_pos
        self.state = DecodeState(caches, self._device_i32(self._cur))
        self.steps = 0
        self.probe: Optional[PerfProbe] = None
        self.tracer: Optional[Tracer] = None
        self.track = "serve"
        self.step_seconds = 0.0
        self.active_slot_steps = 0
        self.admission_stalls = 0          # steps with queued work, no slot
        self.poll_latency_steps_sum = 0    # writeback -> poll observation
        self.poll_latency_n = 0

    def _device_i32(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # -- instrumentation ---------------------------------------------------------
    def attach_probe(self, probe: Optional[PerfProbe]) -> None:
        """Attach a perf counter sink to this engine AND its runtime."""
        self.probe = probe
        self.runtime.attach_probe(probe)

    def attach_tracer(self, tracer: Optional[Tracer], *,
                      track: str = "serve", track_prefix: str = "") -> None:
        """Attach a lifecycle tracer to this engine AND its runtime.

        Request lifecycles render as async spans on ``track``; the
        runtime's channel/completion/translation tracks get
        ``track_prefix``.
        """
        self.tracer = tracer
        self.track = track
        self.runtime.attach_tracer(tracer, track_prefix=track_prefix)

    def perf_counters(self) -> PerfCounters:
        """Engine-side counters under the unified ``serve.*`` namespace,
        plus a nested ``translation`` block (``translation.*``)."""
        depths = self.runtime.speculation_depths()
        raw = {
            "steps": self.steps,
            "step_seconds": self.step_seconds,
            "active_slot_steps": self.active_slot_steps,
            "mean_active_slots":
                self.active_slot_steps / self.steps if self.steps else 0.0,
            "completed": len(self.completed),
            "admission_stalls": self.admission_stalls,
            "admission_stall_rate":
                self.admission_stalls / self.steps if self.steps else 0.0,
            "completion_poll_latency_steps":
                (self.poll_latency_steps_sum / self.poll_latency_n
                 if self.poll_latency_n else 0.0),
            # Steps are scheduling outcomes — deterministic under a fixed
            # seed — so the tail latencies gate.
            "request_latency_steps_p50": self.request_latency.percentile(50),
            "request_latency_steps_p99": self.request_latency.percentile(99),
            "request_latency_steps": self.request_latency.snapshot(),
            # Live §II-C speculation depth of the runtime under this engine
            # (mean over channels).
            "speculation_depth":
                float(np.mean(list(depths.values()))) if depths else 0.0,
        }
        return namespaced(
            raw, "serve",
            extra={"translation": self.runtime.translation_stats()})

    # -- API -------------------------------------------------------------------
    def submit(self, req) -> Optional[Ticket]:
        """Admit a request for continuous batching.

        Takes a :class:`~repro_torch.runtime.SubmitRequest` whose
        ``request`` field is the serve :class:`Request` (``on_complete``
        rides along) and returns the completion descriptor's
        :class:`~repro_torch.runtime.Ticket` with ``uid`` set. A bare
        ``Request`` (the removed legacy form) raises ``TypeError``.
        """
        if not isinstance(req, SubmitRequest):
            reject_legacy_submit("ServeEngine.submit", req)
        if req.request is None:
            raise ValueError(
                "ServeEngine.submit needs SubmitRequest.request set to "
                "a serve Request")
        return self._admit_request(req.request,
                                   on_complete=req.on_complete)

    def _admit_request(self, req: Request, on_complete=None) -> Ticket:
        res = self.runtime.submit_control(
            payload=req.uid, channel=self._completion_channel,
            on_complete=on_complete)
        self._tickets[req.uid] = res.tickets[-1]
        self._ticket_uid[res.tickets[-1]] = req.uid
        self._submitted_at[req.uid] = self.steps
        self.queue.append(req)
        tr = self.tracer
        if tr is not None and tr.sampled(req.uid):
            # One async span per request lifetime, correlated by uid; the
            # matching "e" fires at the §II-D writeback in step().
            tr.async_begin("request", self.track, id=req.uid,
                           ticket=res.tickets[-1], uid=req.uid)
            tr.instant("request.submit", self.track, uid=req.uid,
                       ticket=res.tickets[-1])
        return dataclasses.replace(res, uid=req.uid)

    def poll_completed(self) -> List[Request]:
        """Scheduler-side completion polling via descriptor writeback flags.

        Drains the runtime (retiring written-back ring entries into the
        completion queue) and returns every request whose writeback has
        been observed — either as a retired completion event or by
        scanning live ring slots, so a finished request is visible even
        while in-order retirement is blocked behind an older one.
        """
        self.runtime.drain_all()
        done_tickets = [rec.ticket for rec in self.runtime.poll()]
        ring = self.runtime.channels[self._completion_channel].ring
        done_tickets.extend(ring.live_done_tickets())
        for ticket in done_tickets:
            uid = self._ticket_uid.get(ticket)
            if uid is not None and uid in self.completed:
                if uid not in self._delivered:
                    # Poll latency: decode steps between the §II-D
                    # writeback and the scheduler observing it here.
                    latency = self.steps - self._completed_at.get(
                        uid, self.steps)
                    self.poll_latency_steps_sum += latency
                    self.poll_latency_n += 1
                    if self.probe is not None:
                        self.probe.on_serve_completion(
                            latency_steps=latency)
                    tr = self.tracer
                    if tr is not None and tr.sampled(uid):
                        tr.instant("delivered", self.track, uid=uid,
                                   poll_latency_steps=latency)
                self._delivered[uid] = self.completed[uid]
        return list(self._delivered.values())

    def run(self, max_steps: int = 1000) -> Dict[int, Request]:
        while (self.queue or any(s.busy for s in self.slots)) \
                and self.steps < max_steps:
            self.step()
        return self.completed

    # -- engine internals --------------------------------------------------------
    def _reset_slot_caches(self, b: int) -> None:
        """Clear row ``b`` of every cache in place: position tags are
        authoritative, so tags of -1 invalidate the ring; a ``MambaCache``
        row's conv inputs and state go to 0."""
        caches = self.state.caches
        rows = [(c, b) for c in caches["prefix"]]
        rows += [(c, (slice(None), b)) for c in caches["slots"]]  # (P, B, ..)
        for c, row in rows:
            for name, x in zip(c._fields, c):
                x[row] = -1 if name == "kv_pos" else 0
        self._cur[b] = 0

    def _admit(self) -> None:
        for b, slot in enumerate(self.slots):
            if not slot.busy and self.queue:
                slot.request = self.queue.popleft()
                slot.prompt_cursor = 0
                self._reset_slot_caches(b)
        if self.queue:
            # Admission stall: requests are waiting but every slot is busy
            # — the continuous-batching pressure signal the perf sweep
            # gates (DESIGN.md §5).
            self.admission_stalls += 1
            if self.probe is not None:
                self.probe.on_admission_stall()

    def step(self) -> None:
        t0 = monotonic()
        self._admit()
        active = np.array([s.busy for s in self.slots])
        if not active.any():
            return
        tokens = np.zeros((self.capacity,), np.int32)
        for b, slot in enumerate(self.slots):
            if not slot.busy:
                continue
            r = slot.request
            if slot.prompt_cursor < len(r.prompt):
                tokens[b] = r.prompt[slot.prompt_cursor]
            else:
                tokens[b] = r.output[-1] if r.output else 0

        # Advance only active slots (inactive ring writes are invalidated on
        # admit via tag reset). One upload carries the step's tokens, its
        # positions and the positions after it; one download brings the
        # sampled tokens back.
        cur = np.where(active, self._cur + 1, self._cur).astype(np.int32)
        up = self._device_i32(np.stack([tokens, self._cur, cur]))
        logits, _ = decode_step(self.params, up[0],
                                DecodeState(self.state.caches, up[1]),
                                self.cfg)
        sampled = logits.argmax(dim=-1).cpu().numpy()
        self._cur = cur
        self.state = DecodeState(self.state.caches, up[2])

        for b, slot in enumerate(self.slots):
            if not slot.busy:
                continue
            r = slot.request
            if slot.prompt_cursor < len(r.prompt):
                # Consumed one prompt token; the step that consumes the LAST
                # prompt token emits the first generated token.
                slot.prompt_cursor += 1
                if slot.prompt_cursor < len(r.prompt):
                    continue
            tok = int(sampled[b])
            r.output.append(tok)
            finished = (len(r.output) >= r.max_new_tokens
                        or (r.eos_id is not None and tok == r.eos_id)
                        or int(cur[b]) >= self.max_len - 1)
            if finished:
                self.completed[r.uid] = r
                self._completed_at[r.uid] = self.steps + 1  # post-step index
                # §II-D completion writeback: first 8 bytes -> all ones,
                # applied to the request's ring slot through the runtime.
                self.runtime.complete(self._tickets[r.uid])
                latency = self.steps + 1 - self._submitted_at.get(r.uid, 0)
                self.request_latency.record(latency)
                if self.probe is not None:
                    self.probe.on_request_latency(latency)
                tr = self.tracer
                if tr is not None and tr.sampled(r.uid):
                    tr.instant("writeback", self.track, uid=r.uid,
                               ticket=self._tickets[r.uid])
                    tr.async_end("request", self.track, id=r.uid,
                                 latency_steps=latency)
                slot.request = None
        self.steps += 1
        dt = monotonic() - t0
        n_active = int(active.sum())
        self.step_seconds += dt
        self.active_slot_steps += n_active
        if self.probe is not None:
            self.probe.on_serve_step(n_active, dt)
        tr = self.tracer
        if tr is not None and tr.sampled(self.steps - 1):
            tr.complete("serve.step", self.track, t0 * 1e6, dt * 1e6,
                        step=self.steps - 1, active_slots=n_active)
