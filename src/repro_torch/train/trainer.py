"""Training loop with production posture: auto-resume from the latest
committed checkpoint, periodic async saves (data-iterator state included),
straggler detection via per-step EWMA timing, and preemption-safe shutdown.

The reference's ``repro/train/trainer.py``, on ``device`` (``cuda`` unless
the caller passes ``"cpu"``): parameters come from the port's
``init_params(seed, cfg, device)``, numpy batches from the
:class:`DataIterator` are moved to the device each step.

Under a process mesh (the launcher's ``--mesh-data``), each rank trains
its blocks of the state (``train.shard_state``) on its mesh device, reads
the rows of its position along the batch axes (``data.mesh_hosts``), and
saves and resumes through the checkpointer's mesh form: rank 0 writes.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data import (DataConfig, DataIterator, IteratorState,
                              mesh_hosts)
from repro_torch.device import resolve_device
from repro_torch.distributed import shardlib
from repro_torch.models import init_params

from .step import (TrainConfig, init_state, make_train_step, shard_state,
                   state_block_specs, state_shapes)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3
    seed: int = 0
    straggler_threshold: float = 3.0    # x EWMA step time -> flag


class StragglerMonitor:
    """Flags steps whose wall time exceeds `threshold` x EWMA — on real
    fleets this feeds the controller that re-schedules slow hosts."""

    def __init__(self, threshold: float, alpha: float = 0.1):
        self.ewma: Optional[float] = None
        self.threshold = threshold
        self.alpha = alpha
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append(step)
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 run: TrainerConfig, data_cfg: DataConfig,
                 log_fn: Callable[[int, Dict], None] = None, device=None):
        self.cfg, self.tcfg, self.run = cfg, tcfg, run
        self.mesh = shardlib.process_mesh()
        if self.mesh is not None:
            host_id, num_hosts = mesh_hosts(self.mesh)
            data_cfg = dataclasses.replace(data_cfg, host_id=host_id,
                                           num_hosts=num_hosts)
            device = self.mesh.device
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.ckpt = Checkpointer(run.checkpoint_dir,
                                 keep=run.keep_checkpoints)
        self.monitor = StragglerMonitor(run.straggler_threshold)
        self.log_fn = log_fn or (lambda s, m: None)
        self.step_fn = make_train_step(cfg, tcfg)
        self._preempted = False

    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    # -- lifecycle -----------------------------------------------------------
    def init_or_resume(self):
        params = init_params(self.run.seed, self.cfg, self.device)
        if self.mesh is None:
            state = init_state(params, self.tcfg)
        else:
            state = shard_state(params, self.cfg, self.tcfg, self.mesh)
        del params
        start_step = 0
        it_state = IteratorState()
        latest = self.ckpt.latest_step()
        if latest is not None:
            if self.mesh is None:
                state, extra = self.ckpt.restore(latest, state)
            else:
                state, extra = self.ckpt.restore(
                    latest, state_shapes(self.cfg, self.tcfg),
                    mesh=self.mesh, specs=self._specs())
            start_step = latest
            it_state = IteratorState.from_dict(
                extra.get("iterator", {"step": latest}))
        return state, start_step, it_state

    def _specs(self):
        return state_block_specs(self.cfg, self.mesh, self.tcfg)

    def _save(self, step: int, state, data, blocking: bool = False):
        extra = {"iterator": data.state.to_dict()}
        if self.mesh is None:
            self.ckpt.save(step, state, blocking=blocking, extra=extra)
        else:
            self.ckpt.save(step, state, extra=extra, mesh=self.mesh,
                           specs=self._specs())

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()
                if k in ("tokens", "labels", "loss_mask")}

    def train(self) -> Dict:
        self._install_signal_handler()
        state, start_step, it_state = self.init_or_resume()
        data = DataIterator(self.data_cfg, it_state)
        losses = []
        step = start_step
        try:
            for step in range(start_step, self.run.total_steps):
                t0 = time.perf_counter()
                batch = self._to_device(next(data))
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.perf_counter() - t0
                if self.monitor.observe(step, dt):
                    self.log_fn(step, {"straggler_step_time": dt})
                if (step + 1) % self.run.log_every == 0:
                    self.log_fn(step, {"loss": loss, "step_time": dt})
                if (step + 1) % self.run.checkpoint_every == 0 \
                        or self._preempted:
                    self._save(step + 1, state, data)
                if self._preempted:
                    break
        finally:
            self._save(step + 1, state, data, blocking=True)
            data.close()
        return {"final_step": step + 1, "losses": losses,
                "stragglers": self.monitor.flagged}
