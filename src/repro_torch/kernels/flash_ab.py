"""Side-by-side timing of builds of ``csrc/flash_attention.cu`` (or, with
``--backward``, of ``csrc/flash_attention_bwd.cu``) on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_ab A.cu B.cu ... \\
        [--backward] [--dtype bfloat16|float32] [--reps 30]

Each source (for example the parent commit's ``flash_attention.cu`` and
this one's) is built with :data:`build.NVCC_FLAGS` into its own library
in a temporary directory and called through its ``flash_attention_launch``
on the same inputs (the launch function that takes the value head dim
beside the head dim; a source from before it took one cannot be loaded
here). A source whose launch takes the log-sum-exp pointer gets a null
one: the serving forward is what is timed, in every build. At each shape
every build is first held against :func:`flash_attention_plain` (rtol =
atol = 2e-2 in bf16, 2e-5 in fp32),
then timed in turns (A, B, ..., B, A: the median of ``--reps`` CUDA-event
timings each, after a warm-up) and its output compared bit for bit with
the first build's, with ``scaled_dot_product_attention``
(``enable_gqa``) timed beside them as the library's yardstick. Prints one
JSON line per build and shape: milliseconds of both turns, achieved
TFLOP/s (4 * D operations per visible pair) and the check. Needs a CUDA
GPU and ``nvcc``; times from two calls (two cards) are not comparable.

``--backward`` does the same for builds of the backward through their
``flash_attention_bwd_launch`` (one signature since it was first written;
the scratch is sized for the largest need, :func:`bwd_scratch_floats`) at
:data:`BWD_SHAPES`: each build's dQ, dK and dV are first held against
:func:`flash_attention_backward_plain` (within 3e-2 in bf16, 2e-4 in fp32,
of the largest reference entry) on the plain forward's output and
log-sum-exp, then timed in turns beside SDPA's backward
(``torch.autograd.grad`` of ``scaled_dot_product_attention``), with 10 * D
operations per visible pair (S, dO V^T, dV, dQ, dK).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from . import build
from .flash_attention import (bwd_scratch_floats,
                              flash_attention_backward_plain,
                              flash_attention_plain)

#: (B, S, H, KV, D, causal): the dbrx-132b prefill's shape first, then
#: qwen2.5-3b's (phase (l)'s prefill and phase (p)'s training batch).
SHAPES = {
    torch.bfloat16: [(4, 2048, 48, 8, 128, 1), (4, 512, 16, 2, 128, 1),
                     (1, 4096, 48, 8, 128, 1),
                     (4, 2048, 48, 8, 128, 0), (4, 2048, 48, 8, 64, 1)],
    torch.float32: [(1, 2048, 48, 8, 128, 1), (2, 1000, 48, 8, 64, 1)],
}
#: (B, S, H, KV, D, causal) of the backward: qwen2.5-3b's training batch,
#: then a long causal sequence.
BWD_SHAPES = [(4, 512, 16, 2, 128, 1), (1, 2048, 16, 2, 128, 1)]
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
                 if "C7513" in ln or "spill" in ln]
        print(json.dumps({"build": str(src), "ptxas_notes": notes}))
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def _launchers(sources):
    """One ``flash_attention_launch`` per source."""
    fns = []
    for src, lib in zip(sources, _libraries(sources)):
        takes_lse = "float* lse" in Path(src).read_text()
        fn = lib.flash_attention_launch
        n_ptr = 5 if takes_lse else 4
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if takes_lse:
            fn = lambda q, k, v, o, *rest, fn=fn: fn(q, k, v, o, None,  # noqa
                                                     *rest)
        fns.append(fn)
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


def backward(args, dtype) -> None:
    """The ``--backward`` comparison (see the module)."""
    fns = []
    for lib in _libraries(args.sources):
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, h, kv, d, causal in BWD_SHAPES:
        q, do = (torch.randn((b, s, h, d), device="cuda",
                             generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, s, kv, d), device="cuda",
                            generator=gen).to(dtype) for _ in range(2))
        out, lse = flash_attention_plain(q, k, v, causal=bool(causal),
                                         return_lse=True)
        want = flash_attention_backward_plain(q, k, v, out, lse, do,
                                              causal=bool(causal))
        scratch = torch.empty(bwd_scratch_floats(b, s, h),
                              dtype=torch.float32, device="cuda")
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 10 * b * h * d * pairs
        calls, checks = [], []
        for fn in fns:
            got = [torch.empty_like(x) for x in (q, k, v)]
            calls.append(lambda fn=fn, got=got: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                *(x.data_ptr() for x in got), b, s, s, h, kv, d, d, causal,
                0, _CODE[dtype], stream))
            err = calls[-1]()
            torch.cuda.synchronize()
            rel = [float((x.float() - y.float()).abs().max())
                   / max(float(y.float().abs().max()), 1e-30)
                   for x, y in zip(got, want)]
            checks.append({"rc": err, "rel_err_dq_dk_dv": rel,
                           "within_tol": max(rel) <= _BWD_TOL[dtype]})
        ms = [[] for _ in fns]
        for i in list(range(len(fns))) + list(range(len(fns)))[::-1]:
            ms[i].append(_time_ms(calls[i], args.reps))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o_lib = sdpa(qt, kt, vt, is_causal=bool(causal), enable_gqa=True)
        dot = do.transpose(1, 2)
        lib_ms = _time_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), dot, retain_graph=True), args.reps)
        shape = {"B": b, "S": s, "H": h, "KV": kv, "D": d,
                 "causal": bool(causal), "dtype": args.dtype,
                 "pass": "backward"}
        print(json.dumps({**shape, "sdpa_bwd_ms": lib_ms,
                          "sdpa_bwd_tflops": ops / lib_ms / 1e9}))
        for src, check, t in zip(args.sources, checks, ms):
            print(json.dumps({**shape, "source": str(src), "ms": t,
                              "tflops": ops / min(t) / 1e9, **check}))
        del q, k, v, do, out, lse, want, scratch, o_lib, qt, kt, vt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--backward", action="store_true",
                    help="time builds of flash_attention_bwd.cu")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: needs a CUDA GPU")
    dtype = getattr(torch, args.dtype)
    if args.backward:
        backward(args, dtype)
        return 0
    fns = _launchers(args.sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, h, kv, d, causal in SHAPES[dtype]:
        q = torch.randn((b, s, h, d), device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn((b, s, kv, d), device="cuda",
                            generator=gen).to(dtype) for _ in range(2))
        want = flash_attention_plain(q, k, v, causal=bool(causal)).float()
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 4 * b * h * d * pairs
        calls, checks, outs = [], [], []
        for fn in fns:
            o = torch.empty_like(q)
            calls.append(lambda fn=fn, o=o: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
                s, h, kv, d, d, causal, 0, _CODE[dtype], stream))
            err = calls[-1]()
            torch.cuda.synchronize()
            diff = (o.float() - want).abs()
            tol = _TOL[dtype]
            outs.append(o)
            checks.append({"rc": err, "max_abs_err": float(diff.max()),
                           "within_tol": bool((diff <= tol + tol
                                               * want.abs()).all()),
                           "bit_identical_to_first": torch.equal(o,
                                                                 outs[0])})
        ms = [[] for _ in fns]
        for i in list(range(len(fns))) + list(range(len(fns)))[::-1]:
            ms[i].append(_time_ms(calls[i], args.reps))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = _time_ms(lambda: sdpa(qt, kt, vt, is_causal=bool(causal),
                                       enable_gqa=True), args.reps)
        shape = {"B": b, "S": s, "H": h, "KV": kv, "D": d,
                 "causal": bool(causal), "dtype": args.dtype}
        print(json.dumps({**shape, "sdpa_ms": lib_ms,
                          "sdpa_tflops": ops / lib_ms / 1e9}))
        for src, check, t in zip(args.sources, checks, ms):
            print(json.dumps({**shape, "source": str(src), "ms": t,
                              "tflops": ops / min(t) / 1e9, **check}))
        del q, k, v, want, outs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
