#!/usr/bin/env python3
"""How exact the flash backward is where the keys share a large mean, on
one NVIDIA GPU: seamless-m4t-medium's cross-attention over stub frames.

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``:

    PYTHONPATH=src python3 tools/flash_grad_precision.py [--seed N]

It draws seamless-m4t-medium at its published config from ``--seed``,
takes the batch phase (q) of ``chip_smoke.py`` trains it on (4 x 512
tokens, 512 stub frames), and runs one ``grads_and_metrics`` in bf16
compute through the kernels, capturing each flash backward's inputs. Then:

1. For the last decoder layer's cross-attention, the first decoder
   layer's and the first encoder layer's attention (in the order the
   backward ran): the keys' common share (the norm of their mean over
   positions against theirs), and the cosine to fp64 autograd of the
   softmax on the same bf16 inputs of dQ, dK and dV from the kernel,
   from autograd of ``flash_attention_plain``, and from the explicit
   backward in fp32 with Delta = rowsum(dO * O) from the bf16 output,
   with Delta = rowsum(P * dP), and with Delta = rowsum(P * dP) but dS
   rounded to bf16 before dQ and dK (as one bf16 operand would be).
2. The model's gradients three ways: bf16 compute through the kernels,
   bf16 compute on the plain ops, fp32 compute on the plain ops; for the
   leaves whose two bf16 runs agree least, the cosine of each bf16 run to
   the fp32 one and the leaf's share of the global norm.

Prints one JSON line per item. The card's name and power limit come
first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def fp64_grads(torch, q, k, v, dout, causal):
    """dQ, dK, dV of softmax attention in fp64 on the same inputs."""
    h, kv = q.shape[2], k.shape[2]
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    kk, vv = (x.repeat_interleave(h // kv, dim=2) for x in leaves[1:])
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], kk) * q.shape[-1] ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        s = s.masked_fill(~torch.ones(sq, sk, dtype=torch.bool,
                                      device=q.device).tril(), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    return torch.autograd.grad(out, leaves, dout.double())


def explicit(torch, q, k, v, out, lse, dout, causal, delta_from_out,
             ds_bf16):
    """The explicit backward in fp32 (GQA groups of one here), with Delta
    from the output or rowsum(P * dP), dS optionally rounded to bf16."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        sq, sk = s.shape[-2:]
        p = p * torch.ones(sq, sk, device=q.device).tril()
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    if delta_from_out:
        delta = (gf * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    else:
        delta = (p * dp).sum(-1, keepdim=True) / p.sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if ds_bf16:
        ds = ds.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq, dk, dv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_grad_precision: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, shape_key)
    from repro_torch.models import init_params
    from repro_torch.train import grads_and_metrics
    from repro_torch.tree import flatten
    fa = sys.modules["repro_torch.kernels.flash_attention"]

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    spec = next(f for f in chip_smoke.TRAIN_FAMILIES
                if f.arch == "seamless-m4t-medium")
    cfg = get_config(spec.arch)
    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg, device=dev)
    batch = chip_smoke.train_batch(torch, np, dev,
                                   np.random.default_rng(args.seed), cfg,
                                   spec, args.seed)

    # 1. The flash backward's inputs, captured in the order it ran.
    caught, real = [], fa.flash_attention_backward

    def capture(q, k, v, out, lse, dout, *, causal=True, window=None):
        caught.append((causal, q.clone(), k.clone(), v.clone(), out.clone(),
                       lse.clone(), dout.clone()))
        return real(q, k, v, out, lse, dout, causal=causal, window=window)

    fa.flash_attention_backward = capture
    try:
        g_kernel = flatten(grads_and_metrics(params, batch, cfg, 1)[0])
    finally:
        fa.flash_attention_backward = real
    picks = {"last_cross_attention": 0, "first_decoder_self_attention":
             2 * cfg.num_layers - 1, "first_encoder_attention":
             len(caught) - 1}
    for name, i in picks.items():
        causal, q, k, v, out, lse, dout = caught[i]
        want = fp64_grads(torch, q, k, v, dout, causal)
        got = {"kernel": real(q, k, v, out, lse, dout, causal=causal)}
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        got["plain_autograd"] = torch.autograd.grad(
            flash_attention_plain(*leaves, causal=causal), leaves, dout)
        for label, from_out, ds16 in (("delta_from_bf16_out", True, False),
                                      ("delta_rowsum_p_dp", False, False),
                                      ("delta_rowsum_p_dp_ds_bf16", False,
                                       True)):
            got[label] = explicit(torch, q, k, v, out, lse, dout, causal,
                                  from_out, ds16)
        kf = k.float()
        share = float(kf.mean(1, keepdim=True).norm() * kf.shape[1] ** 0.5
                      / kf.norm())
        log({"attention": name, "shape": shape_key(q.shape[-1],
                                                   v.shape[-1], causal),
             "q": list(q.shape), "k": list(k.shape),
             "keys_common_share": share,
             "cosine_to_fp64_dq_dk_dv": {
                 label: [cosine(a, w) for a, w in zip(g, want)]
                 for label, g in got.items()}})
    del caught

    # 2. The gradients three ways.
    with chip_smoke.plain_kernels(torch):
        g_plain = flatten(grads_and_metrics(params, batch, cfg, 1)[0])
    with chip_smoke.plain_kernels(torch):
        g_fp32 = flatten(grads_and_metrics(
            params, batch, dataclasses.replace(cfg, compute_dtype="float32"),
            1)[0])
    total = sum(float((x.double() ** 2).sum()) for x in g_fp32.values()) ** .5
    rows = sorted((cosine(g_kernel[k], g_plain[k]), k) for k in g_fp32)
    for cos, k in rows[:6]:
        log({"leaf": k, "cosine_kernel_bf16_vs_plain_bf16": cos,
             "cosine_kernel_bf16_vs_plain_fp32": cosine(g_kernel[k],
                                                        g_fp32[k]),
             "cosine_plain_bf16_vs_plain_fp32": cosine(g_plain[k],
                                                       g_fp32[k]),
             "share_of_global_norm_fp32": float(g_fp32[k].norm()) / total})
    return 0


if __name__ == "__main__":
    sys.exit(main())
