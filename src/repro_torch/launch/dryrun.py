"""Multi-pod dry run as a count: for every (arch x shape x mesh) cell, the
FLOPs and bytes of the port's own step, counted on PyTorch's ``meta``
device, and the roofline on H100 peaks (:mod:`repro_torch.roofline`).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --subprocess
        # one subprocess per cell, resumable: existing JSONs under
        # $REPRO_DRYRUN_DIR (default experiments/dryrun/) are skipped.

Where the reference lowers and compiles each cell with XLA on placeholder
devices, this runs the step itself on meta tensors at the cell's *global*
shape (train: ``train_step`` under the config's remat policy; prefill:
``models.forward``; decode: ``models.decode_step``). Meta tensors carry
shape and dtype and no storage: the count allocates nothing on any card
and no tensor of the cell's size on the host, as the reference's
placeholder devices hold nothing. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode``, which counts the products
(matmuls, batched matmuls, convolutions, attention) at 2 FLOPs a
multiply-add and leaves elementwise work out; XLA's ``cost_analysis``
counts elementwise work too, so the count sits a little below it. Bytes
come from :class:`ByteCounter`: every aten op that is not a view adds
the bytes of its tensor inputs and outputs, each op as if it read its
inputs from and wrote its outputs to memory. That is an upper bound on
XLA's "bytes accessed", which fuses elementwise chains and reads a fused
value once.

The reference's method is kept: the step is counted at P=1 and P=2
periods with ``attention_impl="proj_only"`` and ``scan_periods=False``,
extrapolated to the full depth (every per-depth cost is affine in P), and
the attention core is added analytically (``roofline.core_totals``) for
train and prefill; decode is counted with its real core. The count is
global; per chip it is divided by the mesh's chips, as the reference
divides its analytic core. ``memory.argument_bytes`` and
``output_bytes`` are exact per-device bytes under the sharding specs
(``distributed.sharding.per_device_bytes``; a prefill's logits are
taken batch-sharded, where the reference lets XLA choose). What a count
cannot see is written as such: ``temp_bytes`` and the peak are ``null``
(no compiler plans the buffers), and the wire bytes and the roofline's
collective term are ``null`` (no partitioned program to parse): not
counted, not 0.

``REPRO_MODEL_OPTS``, ``REPRO_TRAIN_OPTS`` and ``REPRO_SERVE_OPTS`` take
the reference's comma-separated ``k=v`` variants (e.g.
``REPRO_TRAIN_OPTS=cast_params_bf16=1,microbatches=2``,
``REPRO_SERVE_OPTS=tp_only=1,bf16=1,kv_seq_shard=1``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.distributed import shardlib
from repro_torch.distributed.sharding import (
    P,
    activation_rules,
    batch_axis,
    decode_state_specs,
    param_specs,
    per_device_bytes,
    serving_param_specs,
    train_batch_specs,
    train_state_specs,
)
from repro_torch.launch.inputs import (
    decode_state_shapes,
    prefill_input_specs,
    train_input_specs,
    train_state_specs_shapes,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import analysis as ra
from repro_torch.tree import tree_map

#: The reference's result keys of an ``ok`` cell.
RESULT_KEYS = ("memory", "raw_cost_analysis", "extrapolation", "roofline")


def out_dir() -> str:
    return os.environ.get(
        "REPRO_DRYRUN_DIR",
        os.path.join(os.path.dirname(__file__), "..", "..", "..",
                     "experiments", "dryrun"))


def _out_path(mesh_name, arch, shape_name):
    d = os.path.abspath(os.path.join(out_dir(), mesh_name))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape_name}.json")


# ---------------------------------------------------------------------------
# The count
# ---------------------------------------------------------------------------

def _tensor_bytes(tree, seen: set) -> int:
    """Bytes of the tensors in ``tree`` (args, kwargs or an op's output)
    not counted yet in ``seen``."""
    n = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                n += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return n


#: Ops that allocate or relabel without moving data.
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "set_"}


class ByteCounter(TorchDispatchMode):
    """Sums, over every aten op that is not a view, the bytes of its tensor
    inputs and of its outputs (an in-place op's tensor counts as read and
    as written): an upper bound on the memory traffic of the ops it sees,
    which a fusing compiler would cut."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func._schema.name.split("::")[-1]
                in _NO_TRAFFIC):
            self.bytes += _tensor_bytes((args, kwargs), set()) \
                + _tensor_bytes(out, set())
        return out


def count(fn):
    """``({"flops", "bytes"}, fn())``: ``fn``'s FLOPs and bytes (global:
    whatever shapes ``fn`` runs at) and its result."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as byts:
        out = fn()
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(byts.bytes)}, out


def _with_periods(cfg, n: int):
    """Reduced-depth clone: first_k_dense prefix + n periods (same widths)."""
    kw = dict(
        num_layers=cfg.first_k_dense + n * len(cfg.block_pattern),
        attention_impl="proj_only",
        scan_periods=False,
    )
    if cfg.is_encdec:
        enc_per_period = cfg.encoder_layers // (
            (cfg.num_layers - cfg.first_k_dense) // len(cfg.block_pattern))
        kw["encoder_layers"] = max(1, n * enc_per_period)
    return dataclasses.replace(cfg, **kw)


def _opts(var: str) -> dict:
    out = {}
    for kv in filter(None, os.environ.get(var, "").split(",")):
        k, v = kv.split("=")
        out[k] = v
    return out


def _train_config():
    """TrainConfig for the count; perf variants via REPRO_TRAIN_OPTS
    (comma-separated k=v, e.g. 'cast_params_bf16=1,microbatches=2'):
    0 and 1 are booleans, other digits integers."""
    from repro_torch.train import TrainConfig
    opts = {}
    for k, v in _opts("REPRO_TRAIN_OPTS").items():
        opts[k] = (v == "1") if v in ("0", "1") else \
            int(v) if v.isdigit() else v
    return TrainConfig(**opts)


def _serve_opts() -> dict:
    return {k: v == "1" for k, v in _opts("REPRO_SERVE_OPTS").items()}


def _serving_params(cfg, mesh):
    """(meta parameters, specs) for decode/prefill, honoring
    REPRO_SERVE_OPTS=tp_only=1,bf16=1."""
    from repro_torch.models import param_shapes
    opts = _serve_opts()
    params = param_shapes(cfg)
    if opts.get("bf16"):
        params = tree_map(
            lambda p: p.to(cfg.cdtype)
            if p.dtype == torch.float32 and p.ndim >= 2 else p, params)
    spec_fn = serving_param_specs if opts.get("tp_only") else param_specs
    return params, spec_fn(cfg, mesh, params)


def _step(cfg, shape, mesh):
    """``(fn, args, arg_specs, out_specs)``: the cell's step on meta tensors
    at the global shape, its arguments and their specs, and a function
    giving the specs of its outputs."""
    if shape.kind == "train":
        from repro_torch.train import train_step
        tcfg = _train_config()
        state = train_state_specs_shapes(cfg, tcfg)
        batch = train_input_specs(cfg, shape)
        s_spec = train_state_specs(cfg, mesh, state)
        b_spec = train_batch_specs(mesh, shape.global_batch, batch)
        return (lambda: train_step(state, batch, cfg, tcfg),
                (state, batch), (s_spec, b_spec),
                lambda out: (s_spec, tree_map(lambda _: P(), out[1])))
    BA = batch_axis(mesh, shape.global_batch)
    params, p_spec = _serving_params(cfg, mesh)
    if shape.kind == "prefill":
        from repro_torch.models import forward
        batch = prefill_input_specs(cfg, shape)
        b_spec = train_batch_specs(mesh, shape.global_batch, batch)
        return (lambda: forward(params, batch, cfg)[0],
                (params, batch), (p_spec, b_spec),
                lambda out: P(BA, None, None))
    from repro_torch.models import decode_step
    state, tokens = decode_state_shapes(cfg, shape)
    kv_seq = "model" if _serve_opts().get("kv_seq_shard") else None
    s_spec = decode_state_specs(cfg, mesh, state, shape.global_batch,
                                kv_seq_axis=kv_seq)
    return (lambda: decode_step(params, tokens, state, cfg),
            (params, tokens, state), (p_spec, P(BA), s_spec),
            lambda out: (P(BA, None), s_spec))


def _measure(cfg, shape, mesh, chips: int) -> dict:
    """Count one step; per chip (global / chips)."""
    fn = _step(cfg, shape, mesh)[0]
    c, _ = count(fn)
    return {"flops": c["flops"] / chips, "bytes": c["bytes"] / chips,
            "collectives": None}


def count_cell(cfg, shape, mesh, mesh_name: str) -> dict:
    """The count of one cell (``cfg`` at ``shape`` on ``mesh``), as the
    ``ok`` result :func:`run_cell` writes. Raises where the step does.
    A train step takes REPRO_TRAIN_OPTS's TrainConfig."""
    chips = int(mesh.devices.size)
    t0 = time.perf_counter()
    with shardlib.use_mesh(mesh, activation_rules(mesh)):
        # (1) Full depth, core skipped (decode: with it): the outputs'
        # bytes, and a count the extrapolation must reproduce.
        full = cfg if shape.kind == "decode" else dataclasses.replace(
            cfg, attention_impl="proj_only", scan_periods=False)
        fn, args, arg_specs, out_specs = _step(full, shape, mesh)
        arg_bytes = per_device_bytes(args, arg_specs, mesh)
        raw, out = count(fn)
        out_bytes = per_device_bytes(out, out_specs(out), mesh)
        del fn, args, out

        # (2) Loop-aware totals: P=1 / P=2 extrapolation.
        periods = (cfg.num_layers - cfg.first_k_dense) \
            // len(cfg.block_pattern)
        decode_kind = shape.kind == "decode"
        cfg1 = _with_periods(cfg, 1)
        cfg2 = _with_periods(cfg, 2)
        if decode_kind:   # decode has no inner loops: count the real core
            cfg1 = dataclasses.replace(cfg1, attention_impl="blockwise")
            cfg2 = dataclasses.replace(cfg2, attention_impl="blockwise")
        m1 = _measure(cfg1, shape, mesh, chips)
        m2 = _measure(cfg2, shape, mesh, chips)
    count_s = time.perf_counter() - t0

    ext = lambda k: ra.extrapolate(m1[k], m2[k], periods)  # noqa: E731
    flops_pc = ext("flops")
    bytes_pc = ext("bytes")
    if not decode_kind:
        core_f, core_b = ra.core_totals(cfg, shape)   # global -> per chip
        flops_pc += core_f / chips
        bytes_pc += core_b / chips
    if not (flops_pc > 0 and bytes_pc > 0):
        raise RuntimeError(f"dry run of {cfg.name} at {shape.name}: the "
                           f"count read {flops_pc} FLOPs, {bytes_pc} bytes")
    roof = ra.Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=flops_pc, hlo_bytes_per_chip=bytes_pc,
        wire_bytes_per_chip=None, collectives=None,
        model_flops=ra.model_flops(cfg, shape),
        bytes_per_chip_hbm=None,
    )
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "chips": chips, "count_s": count_s,
        "method": "meta-device count: FlopCounterMode FLOPs (products "
                  "only), ByteCounter bytes (unfused upper bound)",
        "memory": {
            "temp_bytes": None,
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "peak_per_device_bytes": None,
        },
        "raw_cost_analysis": {"flops": raw["flops"] / chips,
                              "bytes": raw["bytes"] / chips},
        "extrapolation": {"p1": m1, "p2": m2, "periods": periods},
        "roofline": roof.to_dict(),
    }


def run_cell(arch: str, shape_name: str, mesh_name: str,
             force: bool = False) -> dict:
    path = _out_path(mesh_name, arch, shape_name)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    model_opts = _opts("REPRO_MODEL_OPTS")
    if model_opts:
        cfg = dataclasses.replace(cfg, **model_opts)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "skipped", "reason": why}
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    try:
        result = count_cell(cfg, shape, mesh, mesh_name)
    except Exception as e:  # noqa: BLE001 — recorded; main() counts it
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def all_cells(mesh_names):
    cells = []
    for arch in list_archs():
        for shape_name in SHAPES:
            for mesh_name in mesh_names:
                cells.append((arch, shape_name, mesh_name))
    return cells


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh subprocess")
    args = ap.parse_args(argv)

    mesh_names = ["single", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = all_cells(mesh_names)
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, m) for m in mesh_names]
    else:
        ap.error("--arch and --shape, or --all")

    failures = 0
    for arch, shape_name, mesh_name in cells:
        path = _out_path(mesh_name, arch, shape_name)
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                r = json.load(f)
            print(f"[cached] {mesh_name:8s} {arch:22s} {shape_name:12s} "
                  f"{r['status']}")
            continue
        if args.subprocess:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--mesh", mesh_name]
            if args.force:
                cmd.append("--force")
            proc = subprocess.run(cmd, env=dict(os.environ),
                                  capture_output=True, text=True)
            status = "?"
            if os.path.exists(path):
                with open(path) as f:
                    status = json.load(f)["status"]
            print(f"[subproc] {mesh_name:8s} {arch:22s} {shape_name:12s} "
                  f"{status} (rc={proc.returncode})")
            if status not in ("ok", "skipped"):
                failures += 1
        else:
            r = run_cell(arch, shape_name, mesh_name, force=args.force)
            print(f"[run]    {mesh_name:8s} {arch:22s} {shape_name:12s} "
                  f"{r['status']}"
                  + (f" ({r.get('error', '')[:120]})"
                     if r["status"] == "error" else ""))
            if r["status"] == "error":
                failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
