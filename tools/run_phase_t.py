#!/usr/bin/env python3
"""Phase (t) of ``chip_smoke.py`` alone: flash over the rest of the
reference's attention domain on the card.

Run from the root of a checkout (or name one with ``--root``), on a
machine with a CUDA GPU and ``nvcc``:

    python3 tools/run_phase_t.py [--root CHECKOUT] [--seed 0]

It builds the checkout's kernels (``repro_torch.kernels.build``), prints
the flash kernels' ptxas registers and spills (checked as the smoke
checks them: no tensor-core kernel may spill) and the kernels whose
wgmmas ptxas serialised (warning C7513), turns TF32 off as the
smoke does, and calls that checkout's ``chip_smoke.domain_path``: the
kernels against their plain versions at the reduced configs' head dims
and under the logit softcap, gemma3-12b capped at full width, every
reduced config through both launchers, and rows 7f-7i timed; every line
the smoke prints for (t), then a last line with the phase's seconds, its
launches and flash's launches by shape.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    os.chdir(root)
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("run_phase_t: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    cs.log({"build_seconds": time.perf_counter() - t0})
    fwd = cs.flash_ptxas(build.BUILD_LOG.get("flash_attention"))
    bwd = cs.bwd_ptxas(build.BUILD_LOG.get("flash_attention_bwd"))
    cs.log({"ptxas_flash_attention": fwd, "ptxas_flash_attention_bwd": bwd,
            "serialized_wgmma": [  # ptxas C7513: a kernel that loses ~15 %
                ln.split("function")[-1].strip()
                for log in build.BUILD_LOG.values()
                for ln in log.splitlines() if "C7513" in ln]})
    cs.check_flash_ptxas(fwd)
    cs.check_bwd_ptxas(bwd)
    t0 = time.perf_counter()
    launches, shapes, _ = cs.domain_path(torch, np, torch.device("cuda", 0),
                                         np.random.default_rng(args.seed),
                                         args.seed, smi)
    cs.log({"phase_t_seconds": time.perf_counter() - t0,
            "launches": launches, "flash_launches_by_shape": shapes,
            "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
