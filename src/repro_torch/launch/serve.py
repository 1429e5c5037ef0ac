"""Serving launcher: continuous batching through the port's ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        [--reduced] [--requests 8] [--capacity 4] [--device cpu]

Without ``--reduced`` it serves the published config at full width, with
random weights drawn by ``init_params`` from ``--seed`` on ``--device``
(``cuda`` unless given).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.runtime import SubmitRequest
from repro_torch.serve import Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    params = init_params(args.seed, cfg, args.device)
    engine = ServeEngine(params, cfg, capacity=args.capacity,
                         max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        engine.submit(SubmitRequest(request=Request(
            uid=uid,
            prompt=list(rng.integers(1, cfg.vocab_size, rng.integers(4, 16))),
            max_new_tokens=args.max_new_tokens)))
    done = engine.run(max_steps=10000)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done.values())
    print(f"{len(done)}/{args.requests} requests, {tokens} tokens, "
          f"{engine.steps} steps, {dt:.1f}s "
          f"({tokens/max(dt,1e-9):.1f} tok/s aggregate) on {engine.device}")
    for uid, r in sorted(done.items()):
        print(f"  req {uid}: {r.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
