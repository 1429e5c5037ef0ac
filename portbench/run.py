"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``src/repro_torch``). It builds the cell's set-up,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` and, traced, ``breakdown``; then ``checks``, each
number compared beside its limit (also the last lines of standard
error). It exits with another code than 0, printing no result, without
a card or with fewer than the cell asks for, or if JAX or the JAX
package is loaded once the window has closed.

``--control`` puts the reference at the next lower precision (fp8) in
the program's place and judges it by the cell's own limits, as a run of
the program is judged: its ``correct`` has to come out false. It is for
reading the limits' upper ends; the benchmark's own runs never pass it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _env() -> None:
    """The program's build and kernel caches at fixed paths inside the
    checkout, so only a checkout's first run builds; an allocator that
    does not fragment over the training step's large, varied blocks."""
    cache = ROOT / "build"
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(cache / "repro_torch"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda_cache"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    _env()

    from portbench.harness import core
    age = core.process_age()
    t_start = core.now() - age
    cell = core.cell(args.workload)

    import repro_torch  # noqa: F401  (the program: absent, no run)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all()
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), t_start, args.control)
    if out is None:
        return 3
    print(json.dumps(out))
    return 0


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, control: bool = False, port_cfg=None,
            arch=None):
    """Run ``cell`` on ``device`` and return its result object (None, with
    the reason on standard error, where a forbidden module is loaded).
    ``port_cfg`` and ``arch`` replace the ones the configuration file
    gives (the tests' small sizes)."""
    import torch

    from portbench.harness import core, portcfg
    from portbench.reference.arch import from_config

    ctx = core.Ctx(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=device, t_start=t_start, control=control,
                   port_cfg=port_cfg or portcfg.build(cell.config),
                   arch=arch or from_config(cell.config))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runner = core.load_module(core.BENCH / "kinds" / f"{cell.kind}.py")
    res = runner.run(ctx)
    ok, checks = core.judge(res["numbers"], core.limits(cell.name))
    found = core.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return None
    if control:
        print(json.dumps({"control": cell.name, "seed": seed,
                          "readings": res["numbers"]}), file=sys.stderr)
        for name, c in checks.items():
            print(f"check {name}: {c['value']} (limit {c['limit']})",
                  file=sys.stderr)
        return {"correct": bool(ok), "control": True, "checks": checks}
    run = res["run"]
    metrics = {}
    if trace:
        metrics = core.read_metrics(cell.per_layer, run)
    else:
        metrics["setup_s"] = {"value": res["setup_s"], "unit": "s"}
        metrics.update(core.read_metrics(
            [m for m in cell.end_to_end if m["name"] != "setup_s"], run))
    dev = core.device_info(torch, cell.chips, res["peak"]) \
        if device.type == "cuda" else {"platform": "cpu", "kind": "cpu",
                                       "count": 1, "memory_peak_bytes": 0}
    out = {"correct": bool(ok), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        from portbench.harness import trace as tr
        busy = tr.union_us(run.trace.device, run.trace.start, run.trace.end)
        dev["busy_s"] = busy / 1e6
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = tr.breakdown(run.trace)
    out["checks"] = checks
    print(json.dumps({"readings": res["numbers"]}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return out


if __name__ == "__main__":
    sys.exit(main())
