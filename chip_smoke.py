#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, main path, numbers.

Run from the root of a checkout, on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc/``, holds
each against its plain PyTorch version on the card (bit for bit), drives
the DMA runtime's main path at full size, and checks every result against
the plain functions applied to a copy of the pools taken before the drain.

Phases:

1. Header: the card's name and power limit, the kernels' build time.
2. ``descriptor_copy`` and ``quantize_copy`` against their plain versions
   (fp32, bf16 and integer rows; -1 entries, bucket padding, duplicate
   destinations, an aliased move chain, an all-zero block, exact .5 ties,
   mixed magnitudes), with their times, the bytes they move and the bound.
3. The main path: one layer's paged KV cache in the KV geometry of
   qwen3-14b (8 KV heads, head dim 128, pages of 16 tokens, fp32; 8,192
   pages of 64 KiB per pool), 64 sequences grown interleaved, then
   (a) ``move_pages`` of a 512-page burst through a 4-channel blocked_2d
   runtime (fused drain -> ``descriptor_copy_bucketed``),
   (b) ``defragment(mode="copy")`` of a fragmented sequence,
   (c) the burst on a ``use_kernel=True`` channel (``descriptor_copy``),
   (d) a kv_int8 serial chain of page-aligned rows over the flat pool
   (``quantize_copy_bucketed``), and (e) the same chain as an identity
   transfer (``descriptor_copy_bucketed``). Each phase checks its pools,
   its §II-D writebacks and that its kernel launched.
4. A ``kernels`` JSON line, then the ``ok`` JSON line last.

Any failure raises and the script exits non-zero without the last line.
It exits non-zero at once when no CUDA GPU is present or when the
package's sources are not next to it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
QUANT_OPS_PER_ELEM = 7         # abs, max, div, round, 2x clamp, mul

PAGE, KV_HEADS, HEAD_DIM, NUM_PAGES = 16, 8, 128, 8192
ROW = PAGE * KV_HEADS * HEAD_DIM          # 16,384 floats = 64 KiB
SEQS, TOKENS, BURST = 64, 1024, 512


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(torch, fn, reps: int = 9, warm: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int) -> tuple:
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, np, dev, rng) -> dict:
    from repro_torch.kernels import build
    from repro_torch.kernels.descriptor_copy import (
        descriptor_copy, descriptor_copy_bucketed, descriptor_copy_plain)
    from repro_torch.kernels.quantize_copy import (
        quantize_copy_bucketed, quantize_copy_plain)

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    errs = {"descriptor_copy": 0.0, "quantize_copy": 0.0}

    def compare(name, kernel, plain, dst):
        want = plain(dst.clone())
        got = kernel(dst.clone())
        torch.cuda.synchronize()
        errs[name] = max(errs[name], max_err(torch, got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"{name} disagrees with its plain version")

    def indices(rows, n, *, dup=0, neg=0):
        sidx = rng.choice(rows, n, replace=False).astype(np.int64)
        didx = rng.choice(rows, n, replace=False).astype(np.int64)
        if dup:
            didx[rng.choice(n, dup, replace=False)] = didx[0]
        if neg:
            sidx[rng.choice(n, neg, replace=False)] = -1
        return sidx, didx

    # descriptor_copy: dtypes and byte paths, -1, padding, duplicates.
    cases = [(torch.float32, NUM_PAGES, ROW), (torch.bfloat16, 2048, ROW),
             (torch.int32, 4096, 3), (torch.uint8, 4096, 7)]
    for dtype, rows, unit in cases:
        src = (torch.randn((rows, unit), device=dev, generator=g) * 100
               ).to(dtype)
        dst = torch.zeros((rows, unit), device=dev, dtype=dtype)
        sidx, didx = indices(rows, BURST, dup=16, neg=8)
        compare("descriptor_copy",
                lambda d: descriptor_copy_bucketed(sidx, didx, src, d,
                                                   n_bucket=2 * BURST),
                lambda d: descriptor_copy_plain(sidx, didx, src, d), dst)
        log({"check": "descriptor_copy", "dtype": str(dtype),
             "rows": rows, "unit": unit, "equal": True})
        del src, dst
    # A move chain inside one pool whose source and destination rows overlap.
    pool = torch.randn((2048, ROW), device=dev, generator=g)
    sidx, didx = np.arange(0, 512), np.arange(256, 768)
    want = descriptor_copy_plain(sidx, didx, pool.clone(), pool.clone())
    got = descriptor_copy(sidx, didx, pool, pool)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("descriptor_copy aliased move disagrees")
    log({"check": "descriptor_copy", "case": "src is dst, overlapping rows",
         "equal": True})
    del pool, got, want

    # quantize_copy: fp32 and bf16 rows, zero block, .5 ties, magnitudes.
    for dtype, rows in ((torch.float32, NUM_PAGES), (torch.bfloat16, 2048)):
        src = torch.randn((rows, ROW), device=dev, generator=g)
        src *= torch.logspace(-4, 3, ROW, device=dev)[torch.randperm(
            ROW, device=dev, generator=g)]
        src[0, :256] = 0                                   # scale floor
        # max |x| = 127 makes the scale exactly 1, so x / scale keeps the
        # .5 fractions: exact ties for round-half-to-even.
        src[1, :256] = torch.arange(256, device=dev) % 254 - 126.5
        src[1, 0] = 127.0
        src = src.to(dtype)
        dst = torch.zeros((rows, ROW), device=dev, dtype=dtype)
        sidx, didx = indices(rows, BURST, dup=16, neg=8)
        sidx[:2] = [0, 1]
        compare("quantize_copy",
                lambda d: quantize_copy_bucketed(sidx, didx, src, d,
                                                 n_bucket=2 * BURST),
                lambda d: quantize_copy_plain(sidx, didx, src, d), dst)
        log({"check": "quantize_copy", "dtype": str(dtype), "rows": rows,
             "unit": ROW, "equal": True})
        del src, dst

    # Times at the main path's shapes: a 512-row burst over full pools.
    src = torch.randn((NUM_PAGES, ROW), device=dev, generator=g)
    dst = torch.zeros_like(src)
    sidx, didx = indices(NUM_PAGES, BURST)
    s_dev = torch.from_numpy(sidx).to(dev)
    d_dev = torch.from_numpy(didx).to(dev)
    s32, d32 = s_dev.to(torch.int32), d_dev.to(torch.int32)
    row_bytes = ROW * 4
    moved = 2 * BURST * row_bytes
    out = {}
    for name, wrapper, plain, ops in (
            ("descriptor_copy",
             lambda: descriptor_copy_bucketed(sidx, didx, src, dst,
                                              n_bucket=BURST),
             lambda: descriptor_copy_plain(sidx, didx, src, dst), 0),
            ("quantize_copy",
             lambda: quantize_copy_bucketed(sidx, didx, src, dst,
                                            n_bucket=BURST),
             lambda: quantize_copy_plain(sidx, didx, src, dst),
             QUANT_OPS_PER_ELEM * BURST * ROW)):
        args = [src.data_ptr(), dst.data_ptr(), s32.data_ptr(),
                d32.data_ptr(), BURST]
        if name == "descriptor_copy":
            args += [row_bytes]
        else:
            args += [ROW, 0]
        stream = torch.cuda.current_stream().cuda_stream
        ms = time_ms(torch, wrapper)
        kernel_ms = time_ms(torch, lambda: build.launch(name, *args, stream))
        plain_ms = time_ms(torch, plain)
        library_ms = None
        if name == "descriptor_copy":
            library_ms = time_ms(torch, lambda: dst.index_copy_(
                0, d_dev, src.index_select(0, s_dev)))
        b_ms, b_by = bound_ms(moved, ops)
        out[name] = {"max_abs_err": errs[name], "ms": ms,
                     "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": moved}
        log({"time": name, "rows": BURST, "row_bytes": row_bytes,
             **out[name], "share_of_bound": b_ms / ms,
             "kernel_share_of_bound": b_ms / kernel_ms})
    del src, dst
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

class Writebacks:
    """Per-phase check that every ticket retired through §II-D."""

    def __init__(self, rt):
        self.rt = rt
        self.t0 = rt._next_ticket
        self.r0 = sum(ch.stats.retired for ch in rt.channels.values())

    def check(self) -> int:
        from repro_torch.core.descriptor import is_done_packed
        rt = self.rt
        issued = rt._next_ticket - self.t0
        retired = sum(ch.stats.retired for ch in rt.channels.values()) \
            - self.r0
        for ch in rt.channels.values():
            if ch.ring.occupancy or ch.ring.live_done_tickets():
                raise AssertionError(f"{ch.name}: ring not drained")
            used = min(ch.ring.tail, ch.ring.capacity)
            if not is_done_packed(ch.ring.table[:used]).all():
                raise AssertionError(f"{ch.name}: slot without writeback")
        if issued == 0 or retired != issued:
            raise AssertionError(f"{retired} of {issued} tickets retired")
        return issued


def run_phase(torch, name, fn, expect, pools, kernels, n_bytes):
    """Drive one phase; check pools, writebacks and kernel launches."""
    from repro_torch.kernels import build
    before = build.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    writebacks = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v - before[k] for k, v in build.launch_counts().items()}
    for got, want in zip(pools(), expect):
        if not torch.equal(got, want):
            raise AssertionError(f"phase {name}: pool differs from the plain "
                                 "functions on the pre-drain copy")
    tickets = writebacks.check()
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"phase {name}: {k} was not launched")
    log({"phase": name, "ms": ms, "bytes": n_bytes, "tickets": tickets,
         "launches": launches})
    return launches


def main_path(torch, np, dev, rng) -> dict:
    from repro_torch.core.chain import from_segments
    from repro_torch.core.pageref import PageRef
    from repro_torch.kernels import build
    from repro_torch.kernels.descriptor_copy import descriptor_copy_plain
    from repro_torch.kernels.quantize_copy import quantize_copy_plain
    from repro_torch.runtime import (
        ChannelConfig, DMARuntime, SubmitRequest, default_runtime)
    from repro_torch.serve.kv_cache import PagedKVCache

    cache = PagedKVCache(page=PAGE, num_pages=NUM_PAGES, max_seqs=SEQS,
                         max_pages_per_seq=TOKENS // PAGE,
                         kv_heads=KV_HEADS, head_dim=HEAD_DIM,
                         dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    cache.k_pages.normal_(generator=g)
    cache.v_pages.normal_(generator=g)
    t0 = time.perf_counter()
    for s in range(SEQS):
        cache.admit(s)
    for step in range(TOKENS // 64):             # interleaved growth
        k = torch.randn((SEQS, 64, KV_HEADS, HEAD_DIM), device=dev,
                        generator=g)
        v = torch.randn((SEQS, 64, KV_HEADS, HEAD_DIM), device=dev,
                        generator=g)
        for t in range(64):
            for s in range(SEQS):
                cache.append(s, k[s, t], v[s, t])
    torch.cuda.synchronize()
    log({"fill": "cache", "sequences": SEQS, "tokens_each": TOKENS,
         "pages_used": NUM_PAGES - cache.alloc.free_pages,
         "pool_bytes": 2 * cache.k_pages.numel() * 4,
         "seconds": time.perf_counter() - t0})

    kp = lambda: cache.k_pages.view(NUM_PAGES, ROW)    # noqa: E731
    vp = lambda: cache.v_pages.view(NUM_PAGES, ROW)    # noqa: E731
    page_bytes = ROW * 4

    def owned(seqs):
        return [int(p) for s in seqs for p in cache.tables[s] if p >= 0]

    def free_dst(n, from_top=True):
        phys = set(cache._phys_free)
        cand = sorted(cache.alloc._free, reverse=from_top)
        out = [p for p in cand if cache._slot(p) in phys][:n]
        assert len(out) == n
        return out

    def move_expect(s, d):
        """The plain copy on a pre-drain clone of each pool (in-pool)."""
        out = []
        for pool in (kp(), vp()):
            c = pool.clone()
            out.append(descriptor_copy_plain(s, d, c, c))
        return out

    def slots(vids):
        return [cache._slot(p) for p in vids]

    build.reset_launches()                    # the main path starts here

    # (a) move_pages burst through the fused rows2d route.
    rt_a = default_runtime(4, tier="blocked_2d", ring_capacity=BURST,
                           device=dev)
    src_a, dst_a = owned(range(8)), free_dst(BURST)
    exp = move_expect(slots(src_a), slots(dst_a))

    def phase_a():
        wb = Writebacks(rt_a)
        cache.move_pages(rt_a, [PageRef(p) for p in src_a],
                         [PageRef(p) for p in dst_a])
        return wb
    run_phase(torch, "a_move_pages_fused", phase_a, exp,
              lambda: (kp(), vp()), ["descriptor_copy"],
              2 * 2 * BURST * page_bytes)
    del exp

    # (b) copy-defragment one fragmented sequence.
    slot_b = 8
    old = owned([slot_b])
    rate0 = cache.alloc.speculation_hit_rate(slot_b)
    dst_phys = sorted(cache._phys_free)[:len(old)]
    exp = move_expect(slots(old), dst_phys)
    dense0 = cache.dense_view(slot_b)

    def phase_b():
        wb = Writebacks(rt_a)
        rate = cache.defragment(slot_b, rt_a, mode="copy")
        if not rate > rate0:
            raise AssertionError(f"defragment left hit rate {rate}")
        return wb
    run_phase(torch, "b_defragment_copy", phase_b, exp,
              lambda: (kp(), vp()), ["descriptor_copy"],
              2 * 2 * len(old) * page_bytes)
    for a, b in zip(cache.dense_view(slot_b), dense0):
        if not np.array_equal(a, b):
            raise AssertionError("defragment changed the sequence's KV")
    del exp, dense0

    # (c) the burst on a use_kernel=True blocked_2d channel.
    rt_c = DMARuntime([ChannelConfig(name="k0", tier="blocked_2d",
                                     use_kernel=True,
                                     ring_capacity=BURST)], device=dev)
    src_c, dst_c = owned(range(16, 24)), free_dst(BURST)
    exp = move_expect(slots(src_c), slots(dst_c))

    def phase_c():
        wb = Writebacks(rt_c)
        cache.move_pages(rt_c, [PageRef(p) for p in src_c],
                         [PageRef(p) for p in dst_c])
        return wb
    run_phase(torch, "c_move_pages_use_kernel", phase_c, exp,
              lambda: (kp(), vp()), ["descriptor_copy"],
              2 * 2 * BURST * page_bytes)
    del exp

    # (d) kv_int8 serial chain over the flat pool; (e) the same, identity.
    rt_d = DMARuntime([ChannelConfig(name="q0", tier="serial", max_len=ROW,
                                     ring_capacity=BURST)], device=dev)
    cold = torch.zeros(NUM_PAGES * ROW, device=dev)
    rt_d.register_pool("kv.flat_k", cache.k_pages.view(-1))
    rt_d.register_pool("cold", cold)
    pages_d = slots(owned(range(24, 32)))
    dst_rows = rng.choice(NUM_PAGES, BURST, replace=False)
    chain = from_segments(np.asarray(pages_d, np.int64) * ROW,
                          dst_rows.astype(np.int64) * ROW,
                          np.full(BURST, ROW, np.int64))
    done = []

    def serial_phase(transform):
        def fn():
            wb = Writebacks(rt_d)
            rt_d.submit(SubmitRequest(chain=chain, src_pool="kv.flat_k",
                                      dst_pool="cold", transform=transform,
                                      on_complete=done.append))
            rt_d.drain_until_idle()
            if len(rt_d.poll()) != 1 or not done:
                raise AssertionError("completion callback did not fire")
            done.clear()
            return wb
        return fn

    for name, transform, plain, kernel in (
            ("d_kv_int8_serial", "kv_int8", quantize_copy_plain,
             "quantize_copy"),
            ("e_identity_serial", None, descriptor_copy_plain,
             "descriptor_copy")):
        exp = [plain(pages_d, dst_rows, kp(),
                     rt_d.pool("cold").view(NUM_PAGES, ROW).clone())]
        run_phase(torch, name, serial_phase(transform), exp,
                  lambda: (rt_d.pool("cold").view(NUM_PAGES, ROW),),
                  [kernel], 2 * BURST * page_bytes)
        del exp
    stats = dict(rt_d.translation_stats())
    if stats["translation.misses"] != 2 or stats["translation.lookups"] != 2:
        raise AssertionError(f"serial chains were not lowered: {stats}")

    counts = build.launch_counts()            # the main path ends here
    log({"main_path_launches": counts})
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log({"device": name, "torch": torch.__version__,
         "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    log({"build_seconds": time.perf_counter() - t0,
         "ptxas": {k: [ln.strip() for ln in v.splitlines()
                       if "registers" in ln or "spill" in ln]
                   for k, v in build.BUILD_LOG.items()}})

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    timing = check_kernels(torch, np, dev, rng)
    launches = main_path(torch, np, dev, rng)

    src = {"descriptor_copy": ("src/repro_torch/kernels/csrc/descriptor_copy.cu",
                               "src/repro/kernels/descriptor_copy.py:39"),
           "quantize_copy": ("src/repro_torch/kernels/csrc/quantize_copy.cu",
                             "src/repro/kernels/quantize_copy.py:52")}
    kernels = []
    for k, (path, replaces) in src.items():
        t = timing[k]
        kernels.append({"name": k, "route": "cuda", "source": path,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "kernel_ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    log(smi)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
