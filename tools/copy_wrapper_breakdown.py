#!/usr/bin/env python3
"""Host-side breakdown of the ``descriptor_copy`` wrapper on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``:

    PYTHONPATH=src python3 tools/copy_wrapper_breakdown.py [--label NAME]

It times, separately, each piece of host work that a lowered drain pays
around one ``descriptor_copy`` launch, at three shapes: the sweep's timed
rows (96 descriptors of 256 B and of 32 B in a bucket of 128), the sharded
migration's drain (4 descriptors of 4 KiB) and the runtime path's burst
(512 descriptors of 64 KiB over 8,192-row pools). The pieces:

1. ``caller_where``: the caller's two ``np.where`` over the descriptor
   fields (``runtime/lowering.py``, ``runtime/channel.py``);
2. ``pad_bucket``: -1 padding of both streams to the bucket;
3. ``prepare``: conversion, range check, ``keep_last`` and the storage
   comparison (``keep_last`` alone is also timed);
4. ``device_i32``: the upload of both streams to the card;
5. ``device_ctx``, ``stream_query`` and ``launch``: entering the device,
   asking for the current stream as a ``torch.cuda.Stream``, and the
   library's launch function called through ctypes;
6. where the checkout has them, the pieces of the by-value route:
   ``int64_streams`` (the pass-through check), ``overlaps``,
   ``current_device`` + ``raw_stream``, and ``tobytes`` of both streams.

Pieces 2-4 are helpers that ``kernels/descriptor_copy.py`` exports; they
are timed whether or not the wrapper still calls them. ``launch`` calls
the launch function with the arguments its argument list takes (device
int32 index arrays, or the host int64 streams as bytes), so the script
runs on either interface. Each piece is the mean host ``perf_counter``
time of ``REPS`` calls. The whole wrapper is timed on the same host clock
and by ``time_per_call_ms`` of ``chip_smoke.py`` (CUDA events around 200
back-to-back calls), beside the bare launch (back to back: the card's own
time when the kernel is longer than its launch; and its device time per
launch under ``torch.profiler``) and ``index_select`` + ``index_copy_``;
the wrapper and the bare launch also as ``time_ms`` of one call, as the
smoke times the main path's shapes. Then ``prefetched_chain_copy`` at the
main path's swap (512 rows of 64 KiB, depth 4) in the same way. Prints
one JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

REPS = 200


def host_us(torch, fn, reps: int = REPS) -> float:
    """Mean host time of ``fn`` in µs over ``reps`` calls (after one)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def device_ms(torch, fn, calls: int = 50):
    """Device time per call of ``fn`` under ``torch.profiler``: the kernels'
    own time summed over ``calls`` calls, divided by ``calls``; None where
    the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us else None


def shapes(np):
    """(label, sidx, didx, bucket, pool rows, row fp32) of the three."""
    from repro_torch.configs import get_config
    from repro_torch.perf.workloads import QUICK, generate

    import chip_smoke

    out = []
    for workload, arch in chip_smoke.SWEEP_SHAPES:
        c = generate(workload, get_config(arch), QUICK, 0).chains[0]
        unit = int(np.asarray(c.length)[0])
        n = c.num_descriptors
        out.append((f"k {workload}/{arch}", np.asarray(c.src) // unit,
                    np.asarray(c.dst) // unit, 1 << max(n - 1, 0).bit_length(),
                    generate(workload, get_config(arch), QUICK, 0).pool_elems
                    // unit, unit))
    rng = np.random.default_rng(0)
    m_rows = 16384                       # 64 MiB of 4 KiB rows per pool
    out.append(("m drain 4 x 4 KiB", rng.choice(m_rows, 4, replace=False),
                np.arange(4), 4, m_rows, 1024))
    out.append(("main 512 x 64 KiB",
                rng.choice(chip_smoke.NUM_PAGES, 512, replace=False),
                rng.choice(chip_smoke.NUM_PAGES, 512, replace=False), 512,
                chip_smoke.NUM_PAGES, chip_smoke.ROW))
    return out


def prefetch_main(torch, np, build) -> dict:
    """``prefetched_chain_copy`` at the main path's swap: 512 rows of 64 KiB
    out of an 8,192-row pool at depth 4, the wrapper and the bare launch
    (either interface), as above."""
    import chip_smoke
    from repro_torch.kernels import prefetch_pipeline as pf

    dev = torch.device("cuda")
    rows, n, unit, depth = chip_smoke.NUM_PAGES, 512, chip_smoke.ROW, 4
    rng = np.random.default_rng(1)
    sidx = rng.choice(rows, n, replace=False).astype(np.int64)
    didx = np.arange(n, dtype=np.int64)
    g = torch.Generator(device=dev).manual_seed(2)
    src = torch.randn((rows, unit), device=dev, generator=g)
    dst = torch.zeros((n, unit), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s_dev = torch.from_numpy(sidx).to(dev)
    d_dev = torch.from_numpy(didx).to(dev)
    if len(build._SYMBOLS["prefetch_pipeline"][2]) == 8:
        s32, d32 = s_dev.to(torch.int32), d_dev.to(torch.int32)
        args = (src.data_ptr(), dst.data_ptr(), s32.data_ptr(),
                d32.data_ptr(), n, unit * 4, depth, stream)
    else:
        args = (src.data_ptr(), dst.data_ptr(), rows, n, sidx.tobytes(),
                didx.tobytes(), n, unit * 4, depth, stream)

    def bare():
        getattr(build, "launch_table", build.launch)("prefetch_pipeline",
                                                     *args)
    return {
        "shape": "prefetched_chain_copy main 512 x 64 KiB, depth 4",
        "wrapper_ms": chip_smoke.time_per_call_ms(
            torch, lambda: pf.prefetched_chain_copy(sidx, didx, src, dst,
                                                    depth=depth), calls=50),
        "wrapper_single_ms": chip_smoke.time_ms(
            torch, lambda: pf.prefetched_chain_copy(sidx, didx, src, dst,
                                                    depth=depth)),
        "kernel_ms": chip_smoke.time_per_call_ms(torch, bare, calls=50),
        "kernel_single_ms": chip_smoke.time_ms(torch, bare),
        "kernel_device_ms": device_ms(torch, bare),
        "library_ms": chip_smoke.time_per_call_ms(
            torch, lambda: dst.index_copy_(
                0, d_dev, src.index_select(0, s_dev)), calls=50),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core.engine import keep_last
    from repro_torch.kernels import build
    from repro_torch.kernels import descriptor_copy as dc

    dev = torch.device("cuda")
    build.build_all(["descriptor_copy"])
    n_args = len(build._SYMBOLS["descriptor_copy"][2])
    for label, s_rows, d_rows, bucket, rows, unit in shapes(np):
        n = len(s_rows)
        # The descriptor fields as the runtime holds them: int32 CPU
        # tensors of element offsets and lengths.
        fsrc = torch.from_numpy((s_rows * unit).astype(np.int32))
        fdst = torch.from_numpy((d_rows * unit).astype(np.int32))
        flen = torch.full((n,), unit, dtype=torch.int32)
        g = torch.Generator(device=dev).manual_seed(1)
        src = torch.randn((rows, unit), device=dev, generator=g)
        dst = torch.zeros_like(src)

        def caller_where():
            ln = np.asarray(flen, np.int64)
            so = np.asarray(fsrc, np.int64)
            do = np.asarray(fdst, np.int64)
            return (np.where(ln == unit, so // unit, -1),
                    np.where(ln == unit, do // unit, -1))

        sidx, didx = caller_where()
        psidx, pdidx = dc.pad_bucket(sidx, didx, bucket)
        ksidx, kdidx, _ = dc.prepare(psidx, pdidx, src, dst, "breakdown")
        s32, d32 = dc.device_i32(ksidx, kdidx, dev)
        active = (psidx >= 0) & (pdidx >= 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row_bytes = unit * 4
        if n_args == 7:                      # device int32 index arrays
            launch_args = (src.data_ptr(), dst.data_ptr(), s32.data_ptr(),
                           d32.data_ptr(), bucket, row_bytes, stream)
        else:                                # host int64 streams, by value
            launch_args = (src.data_ptr(), dst.data_ptr(), rows, rows,
                           sidx.tobytes(), didx.tobytes(), n, row_bytes,
                           stream)

        def bare():
            getattr(build, "launch_table", build.launch)(
                "descriptor_copy", *launch_args)

        def ctx():
            with torch.cuda.device(dev):
                pass

        s_dev = torch.from_numpy(sidx).to(dev)
        d_dev = torch.from_numpy(didx).to(dev)
        pieces = {
            "caller_where": host_us(torch, caller_where),
            "pad_bucket": host_us(torch, lambda: dc.pad_bucket(
                sidx, didx, bucket)),
            "check_pools": host_us(torch, lambda: dc.check_pools(
                src, dst, "breakdown")),
            "prepare": host_us(torch, lambda: dc.prepare(
                psidx, pdidx, src, dst, "breakdown")),
            "keep_last": host_us(torch, lambda: keep_last(pdidx, active)),
            "device_i32": host_us(torch, lambda: dc.device_i32(
                ksidx, kdidx, dev)),
            "device_ctx": host_us(torch, ctx),
            "stream_query": host_us(torch, lambda: torch.cuda.current_stream(
                dev).cuda_stream),
            "launch": host_us(torch, bare),
            "wrapper": host_us(torch, lambda: dc.descriptor_copy_bucketed(
                sidx, didx, src, dst, n_bucket=bucket)),
        }
        if hasattr(dc, "int64_streams"):     # the by-value route's pieces
            pieces.update({
                "int64_streams": host_us(torch, lambda: dc.int64_streams(
                    sidx, didx, "breakdown")),
                "overlaps": host_us(torch, lambda: dc.overlaps(src, dst)),
                "current_device_raw_stream": host_us(
                    torch, lambda: dc.raw_stream(
                        torch.cuda.current_device())),
                "tobytes": host_us(torch, lambda: (sidx.tobytes(),
                                                   didx.tobytes())),
            })
        timed = {
            "wrapper_ms": chip_smoke.time_per_call_ms(
                torch, lambda: dc.descriptor_copy_bucketed(
                    sidx, didx, src, dst, n_bucket=bucket)),
            "wrapper_single_ms": chip_smoke.time_ms(
                torch, lambda: dc.descriptor_copy_bucketed(
                    sidx, didx, src, dst, n_bucket=bucket)),
            "kernel_ms": chip_smoke.time_per_call_ms(torch, bare),
            "kernel_single_ms": chip_smoke.time_ms(torch, bare),
            "kernel_device_ms": device_ms(torch, bare),
            "library_ms": chip_smoke.time_per_call_ms(
                torch, lambda: dst.index_copy_(
                    0, d_dev, src.index_select(0, s_dev))),
        }
        print(json.dumps({"breakdown": args.label, "shape": label,
                          "descriptors": int(active.sum()),
                          "bucket": bucket, "row_bytes": row_bytes,
                          "pool_rows": rows, "host_us": pieces, **timed}),
              flush=True)
        del src, dst
        torch.cuda.empty_cache()
    print(json.dumps({"breakdown": args.label,
                      **prefetch_main(torch, np, build)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
