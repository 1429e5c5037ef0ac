"""Training launcher: the port's Trainer on one device, or SPMD over a
process mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduced [--device cpu] [--steps 100] [--ckpt-dir DIR]
    # a world of ranks (one process a mesh position), e.g. 2 on the CPU:
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
        --device cpu --distributed-init --mesh-data 2 [--mesh-model M] \
        [--multi-pod] [--compress-pods]

Without ``--reduced`` it trains the published config at full width, with
random weights drawn by ``init_params`` on ``--device`` (``cuda`` unless
given); ``--layers N`` cuts its depth. ``--reduced`` runs on the card as
on the CPU: the flash kernels take the reduced configs' head dims. The
data pipeline makes no encoder frames, so the encoder-decoder
(seamless-m4t-medium) does not train here, as in the reference's
launcher. The reference's multi-host flags
(ROADMAP Queue A item 15(d)): ``--distributed-init`` joins the world
``torch.distributed.run`` describes in the environment (NCCL on
``cuda``, one card a process by ``LOCAL_RANK``; gloo on ``cpu``);
``--mesh-data``, ``--mesh-model`` and ``--multi-pod`` lay its ranks on a
(pod 2,) data, model process mesh and install it with
``activation_rules``; ``--compress-pods`` reduces the gradients across
pods with the EF-int8 all-reduce.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.distributed import shardlib
from repro_torch.distributed.sharding import activation_rules
from repro_torch.train import Trainer, TrainConfig, TrainerConfig


def _init_distributed(device: str) -> str:
    """Join the world of ``torch.distributed.run``'s environment; returns
    this rank's device. On ``cuda``: NCCL, the card ``LOCAL_RANK``."""
    import torch
    import torch.distributed as dist
    if device.startswith("cuda"):
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl")
        return f"cuda:{local}"
    dist.init_process_group("gloo")
    return device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help=">0: cut the config's depth to this many layers")
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

    device = args.device
    if args.distributed_init:
        device = _init_distributed(device)
    if args.compress_pods and not args.multi_pod:
        ap.error("--compress-pods reduces across the pod axis of "
                 "--multi-pod")
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.mesh_data:
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_process_mesh
        backend = dist.get_backend() if dist.is_initialized() else None
        mesh = make_process_mesh(args.mesh_data, args.mesh_model,
                                 2 if args.multi_pod else 0,
                                 backend=backend, device=device)
        shardlib.set_mesh(mesh)
        shardlib.set_rules(activation_rules(mesh))

    tcfg = TrainConfig(
        optimizer=optim.AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10,
                                    total_steps=args.steps),
        microbatches=args.microbatches,
        compress_pod_axis="pod" if args.compress_pods else None)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    run = TrainerConfig(total_steps=args.steps,
                        checkpoint_every=args.ckpt_every,
                        checkpoint_dir=args.ckpt_dir, log_every=10)

    def log(step, metrics):
        print(f"step {step}: " + " ".join(
            f"{k}={float(v):.4f}" if hasattr(v, "__float__") else f"{k}={v}"
            for k, v in metrics.items()), flush=True)

    try:
        result = Trainer(cfg, tcfg, run, dcfg, log_fn=log,
                         device=device).train()
    finally:
        shardlib.clear_mesh()
        if args.distributed_init:
            import torch.distributed as dist
            dist.destroy_process_group()
    print(f"finished at step {result['final_step']}; "
          f"{len(result['stragglers'])} straggler steps")
    return result


if __name__ == "__main__":
    main()
