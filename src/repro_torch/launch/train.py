"""Training launcher: the port's Trainer on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduced --device cpu [--steps 100] [--ckpt-dir DIR]

Without ``--reduced`` it trains the published config at full width, with
random weights drawn by ``init_params`` on ``--device`` (``cuda`` unless
given). The reference's multi-host flags (``--mesh-data``, ``--multi-pod``,
``--compress-pods``, ``--distributed-init``) wait for the collective half
of ROADMAP Queue A item 15(d) (process groups, the sharded step) and
raise; ``distributed/sharding.py``'s specs alone do not run a step.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.train import Trainer, TrainConfig, TrainerConfig

_SHARDING = ("waits for the collective half of ROADMAP Queue A item "
             "15(d): process groups and a sharded step")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help=">0: build a (data, model) mesh and shard")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compress-pods", action="store_true",
                    help="error-feedback int8 allreduce on the pod axis")
    ap.add_argument("--distributed-init", action="store_true",
                    help="join a multi-host process group (real clusters)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    for flag, on in (("--distributed-init", args.distributed_init),
                     ("--mesh-data", args.mesh_data),
                     ("--multi-pod", args.multi_pod),
                     ("--compress-pods", args.compress_pods)):
        if on:
            raise NotImplementedError(f"{flag} {_SHARDING}")

    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(
        optimizer=optim.AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10,
                                    total_steps=args.steps),
        microbatches=args.microbatches)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    run = TrainerConfig(total_steps=args.steps,
                        checkpoint_every=args.ckpt_every,
                        checkpoint_dir=args.ckpt_dir, log_every=10)

    def log(step, metrics):
        print(f"step {step}: " + " ".join(
            f"{k}={float(v):.4f}" if hasattr(v, "__float__") else f"{k}={v}"
            for k, v in metrics.items()), flush=True)

    result = Trainer(cfg, tcfg, run, dcfg, log_fn=log,
                     device=args.device).train()
    print(f"finished at step {result['final_step']}; "
          f"{len(result['stragglers'])} straggler steps")
    return result


if __name__ == "__main__":
    main()
