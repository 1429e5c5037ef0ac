"""Side-by-side timing of builds of ``csrc/flash_attention.cu`` (or, with
``--backward``, of ``csrc/flash_attention_bwd.cu``) on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_ab A.cu B.cu ... \\
        [--backward] [--dtype bfloat16|float32] [--dims 192/128] [--reps 30]

Each source (for example the parent commit's ``flash_attention.cu`` and
this one's) is built with :data:`build.NVCC_FLAGS` into its own library
in a temporary directory and called through its ``flash_attention_launch``
on the same inputs (the launch function that takes the value head dim
beside the head dim; a source from before it took one cannot be loaded
here). A source whose launch takes the log-sum-exp pointer writes it; one
whose launch takes a logit softcap is passed none (0). At each shape every
build is first held against
:func:`flash_attention_plain` (rtol = atol = 2e-2 in bf16, 2e-5 in fp32),
then timed in turns (A, B, ..., B, A: the median of ``--reps`` CUDA-event
timings each, after a warm-up; beside them ``host_us``, the median host
time of one call from an idle card) and its output and log-sum-exp compared
bit for bit with the first build's, with ``scaled_dot_product_attention``
(``enable_gqa``) timed beside them as the library's yardstick. Prints one
JSON line per build and shape: milliseconds of both turns, achieved
TFLOP/s (2 * (D + DV) operations per visible pair) and the check. Needs a
CUDA GPU and ``nvcc``; times from two calls (two cards) are not
comparable. ``--dims`` keeps the shapes of those head dims only (``D``
or ``D/DV``, comma-separated).

``--backward`` does the same for builds of the backward through their
``flash_attention_bwd_launch`` (one signature since it was first written
but for the softcap, passed as none where the source takes one;
the scratch is sized for the largest need, :func:`bwd_scratch_floats`) at
:data:`BWD_SHAPES`: each build's dQ, dK and dV are first held against
:func:`flash_attention_backward_plain` (within 3e-2 in bf16, 2e-4 in fp32,
of the largest reference entry) on the plain forward's output and
log-sum-exp (also their mean distance, ``mean_rel_err_dq_dk_dv``, for
builds whose sums run in another order) and compared bit for bit with the
first build's, then timed in turns beside SDPA's backward
(``torch.autograd.grad`` of
``scaled_dot_product_attention``; where SDPA refuses the shape, its error
is printed instead), with 2 * (3 D + 2 DV) operations per visible pair
(S, dO V^T, dV, dQ, dK).

``--profile`` adds, for each build and shape, one call under
``torch.profiler``: each kernel's device time and its start and end in
microseconds from the call's first kernel (the backward's kernels run on
two streams, and this shows how they overlap).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from . import build
from .flash_attention import (bwd_scratch_floats,
                              flash_attention_backward_plain,
                              flash_attention_plain)

#: The reduced configs' narrow pairs at S 2,048 (B 4, 16 heads; MLA's 24
#: over 16 at one query head a KV head), bf16, causal: chip_smoke.py's
#: rows 7h and 7i.
NARROW = [(4, 2048, 16, 4, 16, 16, 1), (4, 2048, 16, 4, 24, 24, 1),
          (4, 2048, 16, 16, 24, 16, 1), (4, 2048, 16, 4, 32, 32, 1)]
#: (B, S, H, KV, D, DV, causal): the dbrx-132b prefill's shape first, then
#: qwen2.5-3b's (phase (l)'s prefill and phase (p)'s training batch), then
#: deepseek-v2-236b's MLA prefill (phase (o)) and an odd count of query
#: tiles at its heads, then gemma3-12b's prefill (heads of 256), then
#: :data:`NARROW`.
SHAPES = {
    torch.bfloat16: [(4, 2048, 48, 8, 128, 128, 1),
                     (4, 512, 16, 2, 128, 128, 1),
                     (1, 4096, 48, 8, 128, 128, 1),
                     (4, 2048, 48, 8, 128, 128, 0),
                     (4, 2048, 48, 8, 64, 64, 1),
                     (2, 1024, 32, 32, 96, 96, 1),
                     (4, 512, 128, 128, 192, 128, 1),
                     (2, 1152, 64, 64, 192, 128, 1),
                     (4, 512, 128, 128, 192, 128, 0),
                     (2, 2048, 16, 8, 256, 256, 1)] + NARROW,
    torch.float32: [(1, 2048, 48, 8, 128, 128, 1),
                    (2, 1000, 48, 8, 64, 64, 1),
                    (1, 2048, 16, 8, 256, 256, 1)],
}
#: (B, S, H, KV, D, DV, causal) of the backward: qwen2.5-3b's training
#: batch, a long causal sequence, deepseek-v2-236b's training batch (its
#: 128 MLA heads of 192 over 128), then gemma3-12b's (heads of 256), then
#: phi-3-vision-4.2b's (heads of 96; a row is 576 patches and 512
#: tokens), then :data:`NARROW`.
BWD_SHAPES = [(4, 512, 16, 2, 128, 128, 1), (1, 2048, 16, 2, 128, 128, 1),
              (4, 512, 128, 128, 192, 128, 1),
              (2, 2048, 16, 8, 256, 256, 1),
              (4, 1088, 32, 32, 96, 96, 1)] + NARROW
_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _libraries(sources):
    """One library per source, built in parallel (``csrc/`` on the include
    path for its shared headers)."""
    out_dir = Path(tempfile.mkdtemp(prefix="flash_ab_"))
    jobs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"lib{i}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(lib), str(src)]
        jobs.append((src, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for src, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if "C7513" in ln or "spill" in ln or "registers" in ln
                 or "Compiling entry" in ln]
        print(json.dumps({"build": str(src), "ptxas_notes": notes}))
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def _cap(src) -> list:
    """The softcap argument (none) where the source's launch takes one."""
    return [0.0] if "float softcap" in Path(src).read_text() else []


def _launchers(sources):
    """One ``flash_attention_launch`` per source, whether it takes the
    log-sum-exp pointer, and its softcap argument (:func:`_cap`)."""
    fns = []
    for src, lib in zip(sources, _libraries(sources)):
        takes_lse = "float* lse" in Path(src).read_text()
        cap = _cap(src)
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * (5 if takes_lse else 4) \
            + [ctypes.c_int] * 10 + [ctypes.c_float] * len(cap) \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append((fn, takes_lse, cap))
    return fns


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
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


def _host_us(fn, reps: int) -> float:
    """Median host time of one call of ``fn`` in microseconds, from an
    idle card (what a launch-bound caller pays before the card works)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _wanted(shapes, dims):
    """The shapes whose head dims ``dims`` names (all when empty)."""
    if not dims:
        return shapes
    keep = set(dims.split(","))
    return [s for s in shapes
            if str(s[4]) in keep or f"{s[4]}/{s[5]}" in keep]


def _turns(n: int):
    """Build indices in turns: A, B, ..., B, A."""
    return list(range(n)) + list(range(n))[::-1]


def kernel_timeline(call) -> list:
    """[(name, device us, start us, end us)] of the kernels of one
    ``call()``, starts from the first kernel's."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return []
    t0 = min(e.time_range.start for e in evs)
    return [(e.name[:80], e.time_range.elapsed_us(), e.time_range.start - t0,
             e.time_range.end - t0)
            for e in sorted(evs, key=lambda e: e.time_range.start)]


def _pairs(s: int, causal) -> int:
    return s * (s + 1) // 2 if causal else s * s


def backward(args, dtype) -> None:
    """The ``--backward`` comparison (see the module)."""
    fns = []
    for src, lib in zip(args.sources, _libraries(args.sources)):
        cap = _cap(src)
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_float] * len(cap) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append((fn, cap))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, h, kv, d, dv, causal in _wanted(BWD_SHAPES, args.dims):
        q = torch.randn((b, s, h, d), device="cuda", generator=gen).to(dtype)
        do = torch.randn((b, s, h, dv), device="cuda",
                         generator=gen).to(dtype)
        k = torch.randn((b, s, kv, d), device="cuda", generator=gen).to(dtype)
        v = torch.randn((b, s, kv, dv), device="cuda",
                        generator=gen).to(dtype)
        out, lse = flash_attention_plain(q, k, v, causal=bool(causal),
                                         return_lse=True)
        want = flash_attention_backward_plain(q, k, v, out, lse, do,
                                              causal=bool(causal))
        scratch = torch.empty(bwd_scratch_floats(b, s, h),
                              dtype=torch.float32, device="cuda")
        ops = 2 * b * h * (3 * d + 2 * dv) * _pairs(s, causal)
        calls, checks, outs = [], [], []
        for fn, cap in fns:
            got = [torch.empty_like(x) for x in (q, k, v)]
            calls.append(lambda fn=fn, got=got, cap=cap: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                *(x.data_ptr() for x in got), b, s, s, h, kv, d, dv, causal,
                0, _CODE[dtype], *cap, stream))
            err = calls[-1]()
            torch.cuda.synchronize()
            rel = [float((x.float() - y.float()).abs().max())
                   / max(float(y.float().abs().max()), 1e-30)
                   for x, y in zip(got, want)]
            mean_rel = [float((x.float() - y.float()).abs().mean())
                        / max(float(y.float().abs().max()), 1e-30)
                        for x, y in zip(got, want)]
            outs.append(got)
            checks.append({"rc": err, "rel_err_dq_dk_dv": rel,
                           "mean_rel_err_dq_dk_dv": mean_rel,
                           "within_tol": max(rel) <= _BWD_TOL[dtype],
                           "bit_identical_to_first": all(
                               torch.equal(x, y)
                               for x, y in zip(got, outs[0]))})
        ms = [[] for _ in fns]
        for i in _turns(len(fns)):
            ms[i].append(_time_ms(calls[i], args.reps))
        shape = {"B": b, "S": s, "H": h, "KV": kv, "D": d, "DV": dv,
                 "causal": bool(causal), "dtype": args.dtype,
                 "pass": "backward"}
        try:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            o_lib = sdpa(qt, kt, vt, is_causal=bool(causal), enable_gqa=True)
            dot = do.transpose(1, 2)
            lib_ms = _time_ms(lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), dot, retain_graph=True), args.reps)
            print(json.dumps({**shape, "sdpa_bwd_ms": lib_ms,
                              "sdpa_bwd_tflops": ops / lib_ms / 1e9}))
            del o_lib
        except RuntimeError as e:             # SDPA refuses the shape
            print(json.dumps({**shape, "sdpa_bwd_error": str(e)[:300]}))
        for src, check, t, call in zip(args.sources, checks, ms, calls):
            print(json.dumps({**shape, "source": str(src), "ms": t,
                              "tflops": ops / min(t) / 1e9,
                              "host_us": _host_us(call, args.reps),
                              **check}))
            if args.profile:
                print(json.dumps({**shape, "source": str(src),
                                  "profile": kernel_timeline(call)}))
        del q, k, v, do, out, lse, want, scratch, outs, calls


def forward(args, dtype) -> None:
    """The forward comparison (see the module)."""
    fns = _launchers(args.sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, h, kv, d, dv, causal in _wanted(SHAPES[dtype], args.dims):
        q = torch.randn((b, s, h, d), device="cuda", generator=gen).to(dtype)
        k = torch.randn((b, s, kv, d), device="cuda", generator=gen).to(dtype)
        v = torch.randn((b, s, kv, dv), device="cuda",
                        generator=gen).to(dtype)
        want = flash_attention_plain(q, k, v, causal=bool(causal)).float()
        ops = 2 * b * h * (d + dv) * _pairs(s, causal)
        calls, checks, outs = [], [], []
        for fn, takes_lse, cap in fns:
            o = q.new_empty((b, s, h, dv))
            lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()) \
                + ((lse.data_ptr(),) if takes_lse else ())
            calls.append(lambda fn=fn, ptrs=ptrs, cap=cap: fn(
                *ptrs, b, s, s, h, kv, d, dv, causal, 0, _CODE[dtype], *cap,
                stream))
            err = calls[-1]()
            torch.cuda.synchronize()
            diff = (o.float() - want).abs()
            tol = _TOL[dtype]
            outs.append((o, lse if takes_lse else None))
            first_lse = outs[0][1]
            checks.append({
                "rc": err, "max_abs_err": float(diff.max()),
                "within_tol": bool((diff <= tol + tol * want.abs()).all()),
                "bit_identical_to_first": torch.equal(o, outs[0][0]),
                "lse_bit_identical_to_first": None
                if not takes_lse or first_lse is None
                else torch.equal(lse, first_lse)})
        ms = [[] for _ in fns]
        for i in _turns(len(fns)):
            ms[i].append(_time_ms(calls[i], args.reps))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = _time_ms(lambda: sdpa(qt, kt, vt, is_causal=bool(causal),
                                       enable_gqa=True), args.reps)
        shape = {"B": b, "S": s, "H": h, "KV": kv, "D": d, "DV": dv,
                 "causal": bool(causal), "dtype": args.dtype}
        print(json.dumps({**shape, "sdpa_ms": lib_ms,
                          "sdpa_tflops": ops / lib_ms / 1e9}))
        for src, check, t, call in zip(args.sources, checks, ms, calls):
            print(json.dumps({**shape, "source": str(src), "ms": t,
                              "tflops": ops / min(t) / 1e9,
                              "host_us": _host_us(call, args.reps),
                              **check}))
            if args.profile:
                print(json.dumps({**shape, "source": str(src),
                                  "profile": kernel_timeline(call)}))
        del q, k, v, want, outs, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--backward", action="store_true",
                    help="time builds of flash_attention_bwd.cu")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--dims", default="",
                    help="only these head dims, e.g. 192/128 or 128,64")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--profile", action="store_true",
                    help="also each build's kernels in one call, profiled")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: needs a CUDA GPU")
    dtype = getattr(torch, args.dtype)
    if args.backward:
        backward(args, dtype)
    else:
        forward(args, dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
