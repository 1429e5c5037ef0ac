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
   mixed magnitudes); ``prefetched_chain_copy`` bit for bit (the same
   pools, -1 on both sides, duplicate destinations, depths 2-8, chains of
   0, 1, 3 and 512, an aliased move chain); both copies also at 1 to
   9,000 descriptors around their by-value descriptor tables (128, 512 and
   4,088 pairs; a longer call is cut into several launches, counted
   against the plain model of the launch function's host pass), over
   256-byte rows and 4 KiB rows (the bulk-copy path) with duplicates
   across blocks and launches; ``paged_attention`` within
   rtol = atol = 2e-5 (fp32) and 2e-2 (bf16) (H/KV 40/8 and 8/8, ragged
   lengths with 0 and a partial page, -1 inside and past the length).
   Each with its times at the main path's shapes, the bytes it moves and
   its bound; the paged decode also with a yardstick the port never calls
   (``index_select`` of the dense K/V, then
   ``scaled_dot_product_attention``).
3. The main path: one layer's paged KV cache in the KV geometry of
   qwen3-14b (8 KV heads, head dim 128, pages of 16 tokens, fp32; 8,192
   pages of 64 KiB per pool), 64 sequences of 1,024 tokens grown
   interleaved, q of its 40 query heads, then
   (f) decode over all 64 sequences (``paged_attention``), held against
   the plain version,
   (a) ``move_pages`` of a 512-page burst through a 4-channel blocked_2d
   runtime (fused drain -> ``descriptor_copy_bucketed``),
   (b) ``defragment(mode="copy")`` of a fragmented sequence,
   (c) the burst on a ``use_kernel=True`` channel (``descriptor_copy``),
   then decode again, bit-identical,
   (d) a kv_int8 serial chain of page-aligned rows over the flat pool
   (``quantize_copy_bucketed``), (e) the same chain as an identity
   transfer (``descriptor_copy_bucketed``),
   (g) ``defragment(mode="remap")`` of another sequence, then decode,
   bit-identical,
   (h) §II-C swap-out of 8 sequences: their virtual chains lowered by
   ``translate_chain`` and copied to cold pools by
   ``prefetched_chain_copy_op``, held against the plain version and each
   sequence's dense view, and
   (i) swap-in: the hot pages zeroed (decode must change) and copied back
   (decode bit-identical again).
   Each phase checks its pools (and (a)-(e) their §II-D writebacks) and
   that its kernel launched.
   ``moe_gather`` and ``moe_combine`` bit for bit (main-path shapes from a
   real dispatch plan, all -1, no -1, fp32 and bf16, rows of widths that
   are not a multiple of 8, k of 1, 4 and 6, tokens with every copy
   dropped) and ``flash_attention`` within rtol = atol = 2e-5 (fp32) and
   2e-2 (bf16) (causal and not, windows of 64 and 100, H/KV 48/8, 8/8,
   8/2 and 16/4, S 2,048, 1,000, 777, 333 and 200, 64 queries over 300
   keys, D 64 and 128, q scaled by 8 for large logits; and the head dims
   of phase (o): 96, 192 over values of 128 and 256, at phi-3-vision's,
   deepseek-v2's and gemma3-12b's prefill shapes (gemma3's global and
   local layers) and smaller ones); their times with
   the yardsticks ``index_select`` (gather), ``index_select`` + ``bmm``
   (combine, several calls) and SDPA with ``is_causal`` and ``enable_gqa``
   in bf16 (flash), flash's achieved TFLOP/s beside SDPA's, its kernels'
   registers, shared memory and spills (ptxas; none allowed in a
   tensor-core kernel), the fp32 flash kernel timed at one smaller shape,
   and flash at 96, 192/128 and 256 (causal, bf16, B 2 x S 1,024 x 32
   heads, B 4 x S 512 x 128 heads, and B 2 x S 2,048 x 16/8 heads, also
   with gemma3's window of 1,024) beside its bound and SDPA (``is_causal``,
   whose backends take DV != D; at 256 each backend that takes the call,
   the window as a mask, the fastest its time).
4. (k) The ``dma``/``mmu``/``transform``/``serve``/``sharded`` perf sweep
   on the card, after the pools of phase 3 are freed:
   ``repro_torch.perf.sweep.run_sweep`` with the spec of the committed
   ``BENCH_perf.json`` (quick mode, seed 0, 3 repeats, 4 channels, L 13
   and 100, 10 configs x 4 workloads, 120 runtime passes over pools on
   the card, the serve cell's engine on the card, and the 4 sharded mesh
   cells' runtimes on the card), gated with the port's ``compare``
   against the baseline (0 regressions, 0 errors), then held more
   strictly: every one of the 91 cells' metrics and counters must equal
   the committed values. Prints the
   launches of ``descriptor_copy`` per workload (and per sharded cell)
   and the shapes it ran at
   (it must have launched), the median host wall-clock
   ``launch_us_per_descriptor`` per workload, holds the sweep's drains
   over a random source pool against the CPU runtime bit for bit, and
   times ``descriptor_copy`` at the sweep's small rows and at (m)'s drain
   of 4 descriptors of 4 KiB (wrapper, bare launch function, the same
   with one descriptor as its floor, the plain version and
   ``index_select`` + ``index_copy_``).
5. (j) The model path, after the pools of phase 3 are freed: dbrx-132b at
   its published widths (d 6,144, 48/8 heads of 128, 16 experts top-4 of
   d_ff 10,752, vocab 100,352) cut to 2 layers, weights from
   ``init_params`` with a seeded generator on the card (about 31.7 GB in
   fp32), prefilled with 4 prompts of 2,048 token ids from ``--seed``:
   ``forward`` through ``flash_attention``, ``moe_gather`` and
   ``moe_combine`` (2 launches each), then each prompt's greedy next
   token. Held against the same forward with the three ops replaced by
   their plain versions (inside this script, with the first run's
   dispatch plans replayed so that both route alike; the count of token
   copies the plain run would have routed elsewhere is printed), within
   rtol = atol = 6e-2 on the bf16 logits (about 4 bf16 ulps at the
   largest logits); the greedy tokens must agree wherever the top-2
   margin exceeds that. Prints the phase time, tokens/s, the dropped
   tokens and empty slots (both > 0, so both -1 rules run) and the peak
   device memory; then times the same forward again (set up already) and
   profiles a third one for its device time by kernel name. Then
   ``prefill`` and 4 greedy ``decode_step``s on the same weights (B 4):
   ``moe_gather`` and ``moe_combine`` at 4 tokens a step, held step by
   step against the plain ops from a copy of the prefilled state with the
   plans replayed, at the same tolerance.
6. (l) Serving, after (j)'s weights are freed: qwen2.5-3b at its
   published config (36 layers, d 2,048, 16/2 heads of 128, d_ff 11,008,
   vocab 151,936; about 12.3 GB of fp32 weights from ``--seed``).
   ``prefill`` of 4 prompts of 512 tokens (``max_len`` 640;
   ``flash_attention`` once a layer), 16 greedy ``decode_step``s, then a
   ``ServeEngine`` (capacity 4, ``max_len`` 128) serving 8 requests with
   prompts of 16-64 tokens and 16 new tokens each, polled every 3 steps;
   all 8 must be delivered through their §II-D writebacks. Held: the
   prefill against the same on plain flash (rtol = atol = 6e-2, logits
   and K/V); the decode steps' logits against ``forward`` over the prompt
   and the fed tokens at the same positions (teacher forcing, rtol = atol
   = 8e-2, the reference's tolerance); each request's first token against
   prefill's greedy token for its prompt wherever the top-2 margin exceeds
   8e-2 or twice the largest teacher-forcing error, whichever is more.
   Prints prefill ms and tokens/s, the decode step's
   median ms and tokens/s, the engine's steps, median step ms, generated
   tokens/s, admission stalls and poll latency, the peak device memory,
   and one decode step's device time by kernel name with the share of the
   copy (cast) kernels.
7. (m) Cross-shard KV-page migration, after (l), at qwen2.5-3b's KV
   geometry (2 KV heads of 128, pages of 16 tokens, fp32: 16 KiB a page
   row): 4 logical shards of 4,096 pages on the card (256 MiB a pool, K
   and V from ``--seed``) under ``ShardedDMARuntime`` with the async
   fabric. Four steps, each held against a plain torch oracle (the pools
   before it, with the same page moves applied by indexing), with every
   hop written back (§II-D) and the data rings drained: 1,024 Zipf-hot
   pages (alpha 1.1, as the sharded cells pick them) migrated in waves of
   8; 32 pages flipped to shard 1 and pulled one by one on first touch;
   shard 3 lost with hops into, out of and beside it in flight
   (``ungraceful_resize``; every page lands once on a survivor); an
   ``evacuate``/``readmit`` round trip of shard 2. Prints each step's ms,
   pages/s, bytes, hops, fabric rounds, overlap ratio, drains and
   ``descriptor_copy`` launches (it must launch); then profiles the
   migration repeated: device time by kernel, CUDA runtime calls with the
   ``cudaStreamSynchronize`` count beside the drains, host time by
   function.
8. (n) Sharded serving with (l)'s weights: a ``ShardedServeEngine`` over
   2 logical shards (each a ``ServeEngine`` of capacity 2, ``max_len``
   128) and a 2-shard ``ShardedKVPool`` in the same KV geometry serves 8
   requests (prompts of 8-32 tokens, 8 new tokens, 4 KV pages each; 4
   requests with a page on the shard that loses the route, which
   admission migrates). All 8 must be delivered through their
   writebacks, ``remote_page_reads`` must equal the pulled pages, the
   ``perf_counters()`` keys must be the reference's, and each request's
   tokens must equal an unsharded ``ServeEngine``'s on the same requests
   up to a first difference, where the full forward's top-2 margin must
   be under 8e-2. Prints the engine's median step ms, generated tokens/s
   and requests per shard.
9. (o) Every other model family at its published widths, after (n),
   each drawn from ``--seed`` on the card and freed before the next:
   deepseek-v2-236b cut to 2 of 60 layers (its dense layer 0 and one MoE
   layer: MLA through flash at 192/128, 160 experts top-6; about 5.4 B
   parameters, 21.6 GB fp32), jamba-v0.1-52b cut to one period of 8 of 32
   (7 Mamba-2 layers, 1 attention, 4 MoE of 16 experts; 13.3 B, 53.1 GB),
   and, uncut, mamba2-780m (48 layers), seamless-m4t-medium (12 encoder
   layers over 512 stub frames, 12 decoder layers with cross-attention)
   and phi-3-vision-4.2b (32 layers, head dim 96, 576 stub patch
   embeddings before the tokens); then the dense family uncut with bf16
   parameters: gemma3-12b (48 layers, 40 windowed at 1,024 and 8 global,
   heads of 256; 11.8 B parameters, 23.5 GB), qwen3-14b (40 layers, q/k
   norm; 14.8 B, 29.5 GB) and starcoder2-15b (40 layers, biases, a
   non-gated MLP, G 12; 31 GB), each prefilled with 2 x 2,048 tokens, so
   that gemma3's window and decode ring both wrap, its prefill timed for
   (r). Each: ``prefill`` of 4 x 512 tokens (B
   2 x 448 after the patches for phi-3-vision, 4 x 128 for seamless) and
   8 greedy decode steps (16 for mamba2-780m, which also serves 8 requests
   through a ``ServeEngine``), its flash and MoE launches counted by path
   and flash's by shape; the prefill held against the same on the plain
   ops (the dispatch plans replayed) within rtol = atol = 6e-2, logits and
   every cache; decode held against the full forward (teacher forcing)
   from a prompt that fills one SSD chunk with its steps, MoE capacity
   raised: in fp32 compute within 8e-2; in bf16, on the same tokens and
   with the fp32 forward's experts, against the fp32 forward within the
   larger of 8e-2 and twice the bf16 forward's own error there, the token
   copies that bf16 rounding would route elsewhere counted and held under
   a quarter. Prints the steady prefill's ms and tokens/s (the first,
   cold call's ms beside it), the decode step's median ms and the card's
   busy share of one step, and the peak device memory.
10. (p) Training, after (o): ``flash_attention_bwd`` against
   ``flash_attention_backward_plain`` on the same q, k, v, output,
   log-sum-exp and dO (and that against autograd of the plain forward),
   within 2e-4 (fp32) and 3e-2 (bf16) of the largest reference entry, at
   qwen2.5-3b's training shape (4 x 512, 16/2 heads of 128, causal), a
   window of 128, a non-causal case and small cases at head dims 64, 96
   and 192/128 (windowed, not causal, G 4), deepseek-v2-236b's training
   shape (4 x 512, 128 heads of 192 over 128) and gemma3-12b's (2 x
   2,048, 16 heads of 256 over 8; a window of 1,024, G 1 and G 3), in both
   dtypes, each through the design ``bwd_design`` names (bf16 on the
   tensor cores at every head dim, MLA's through ``dkdv_mla_kernel`` and
   256 through ``dkdv_256_kernel``; fp32 on the CUDA cores); two
   launches bit-identical; the forward's log-sum-exp against the plain
   one; its time at the three training shapes and at S 2,048 beside its
   bound, the plain version and SDPA's backward (at 256 each backend that
   takes it), and ptxas's registers and spills (none allowed in a
   tensor-core kernel). Then
   qwen2.5-3b at its published config (36 layers, fp32 parameters, bf16
   compute, remat "minimal"; weights from ``--seed``): one
   ``grads_and_metrics`` on a 4 x 512 batch of the port's
   ``DataIterator`` through the kernels, held against the same on the
   plain ops (loss within 2e-3 relative, global norm within 1 %, every
   leaf's gradient at cosine >= 0.999; the worst leaf printed); 8
   ``train_step``s through ``make_train_step`` on that batch (the losses
   finite, the last below the first, the lr on its schedule; 72 flash
   forwards and 36 backwards a step, and AdamW's ``adamw_update`` once a
   leaf and ``sum_squares`` once a leaf plus once, checked), with the
   median step ms,
   tokens/s, peak memory, and one profiled step's busy share and device
   time by kernel group. Then the ``Trainer`` at those widths cut to 1
   layer: 4 steps with a checkpoint every 2 (keep 1) into a directory
   under ``build/`` that is removed, resumed to 6, against an
   uninterrupted 6-step run (losses within 1e-5 relative; bit-equality
   printed).
11. (q) Every family trains on the card, after (p): ``moe_gather``'s and
   ``moe_combine``'s backward kernels against their plain versions
   (``d_tokens`` and ``d_expert_out`` bit for bit, ``d_inv_weight``
   within 1e-5 of its largest entry, two launches bit-identical) at the
   training shapes of dbrx-132b (2,048 tokens, k 4, 10,240 slots, d
   6,144), deepseek-v2-236b (k 6, 15,360 slots, d 5,120) and
   jamba-v0.1-52b (k 2, 5,120 slots, d 4,096) from skewed routers, and
   small cases (fp32 and bf16, k 1 and 10, widths of 7, 37 and 100); their
   times at dbrx's shape beside their bounds, the plain versions,
   ``index_add_`` (the gather's) and autograd of the plain combine (the
   combine's). Then nine families at their published widths, each drawn
   from ``--seed``, trained on one ``DataIterator`` batch of 4 x 512
   tokens and freed before the next: dbrx-132b cut to 1 of 40 layers and
   deepseek-v2-236b to 2 of 60 (bf16 parameters), jamba-v0.1-52b to one
   period of 8 (bf16; the kernels' gradients wait on the host while the
   plain ones are computed), mamba2-780m and seamless-m4t-medium (512 stub
   frames) uncut and phi-3-vision-4.2b at 16 of 32 layers (576 stub
   patches; fp32 parameters), gemma3-12b at one period (5 windowed layers
   and 1 global) on 2 x 2,048 tokens, and qwen3-14b and starcoder2-15b at
   2 of 40 layers (bf16 parameters). Each: one ``grads_and_metrics``
   through the kernels (flash forward and backward and the four MoE
   kernels counted against what the config implies under remat, the flash
   backward's launches all of the design ``bwd_design`` names for its
   head dims and compute dtype: the tensor cores in bf16,
   deepseek-v2-236b's MLA heads and gemma3's 256 included; the
   recompute's
   dispatch plans equal to the forward's), held against the same on the
   plain ops
   with the first run's expert choices replayed in order (loss within
   2e-3 relative, global norm within 1 %, every leaf's gradient at cosine
   >= 0.999; the worst leaf printed; seamless-m4t-medium's in fp32
   compute, see TRAIN_FAMILIES); then, except for deepseek and jamba, 4
   ``train_step``s on that batch in bf16 compute (losses finite, the last
   below the first; the step's launches, AdamW's as in (p), checked),
   with the median step ms, tokens/s and peak memory,
   and one profiled step's device time by kernel group.
12. (r) Every step (j), (l), (p) and (q) timed, and (o)'s dense family's
   prefills, read against the dry
   run's FLOP and byte count of the same step (``launch/dryrun.py`` on the
   meta device: the same config, depth and batch, a 1x1 mesh of this
   card; deepseek-v2-236b's and jamba-v0.1-52b's gradient-only first
   calls against a count of the gradients alone) and the H100's peaks
   (989.4 TFLOP/s dense bf16, 3.35 TB/s): one line each with the model
   FLOPs, the counted FLOPs and bytes (a train step's also AdamW's share),
   the roofline's compute and memory terms, step and bottleneck, the
   measured step, ``mfu`` (model FLOPs over the peak times the measured
   step), ``roofline_share`` and the card's name and power limit. The
   counts must read more than 0 and allocate nothing on the card. Then
   the dry-run CLI's qwen3-14b x train_4k x single cell into a temporary
   directory, which must end ``ok`` with the reference's keys.
13. (s) The collective path, after (r): worlds of ranks, one process a
   mesh position, all on this card over gloo (whose collectives copy
   through host memory: its times are loopback, not NVLink), each world
   finished before the next and held against one process on the card;
   a rank that fails or passes S_TIMEOUT fails the smoke. First NCCL with
   two ranks on the card, which must refuse (a duplicate GPU). A world of
   4 ranks, (s2): qwen2.5-3b at published widths cut to 4 of 36 layers
   (fp32 parameters, bf16 compute) on data 2 x model 2, each rank its
   blocks of every state leaf (shaped as ``shard_shape`` says) and 2 x
   512 of the 4 x 512 batch: 3 sharded steps through flash forward and
   backward, tensor-parallel over model (attention, MLP and vocabulary
   leaves as the rank's blocks, gradients reduce-scattered onto theirs),
   a checkpoint rank 0 writes, a fourth step, a fifth at 2 microbatches;
   each rank in turn then runs the one-process steps on the whole batch
   (each step's loss within 2e-3 relative and global norm within 1 %,
   every leaf's moments at cosine >= 0.999 but the key bias's, every
   parameter within 2 lr a step; the fifth against one process's
   ``grads_and_metrics`` at 2 microbatches). Each world prints a
   ``traffic`` line a rank: the bytes a step it gathered and reduced, by
   form, and its peak memory. A world of 2 ranks: (s1) dbrx-132b's MoE FFN at published
   widths in bf16, 4 x 512 tokens on model 2 through ``_moe_ffn_ep``
   (each rank launching ``moe_gather``, ``moe_combine`` and both
   backwards), its output within four bf16 half-ulps of the largest, aux
   and drops equal, the gradients of x, the router and the rank's
   experts at cosine >= 0.999 against the one-process ``moe_ffn``, both
   timed; (s3) dbrx-132b cut to 1 of 40 layers (bf16 parameters) on data
   1 x model 2, 2 sharded steps held as (s2), no byte gathered (every
   leaf split over model computed as the rank's block), the ranks'
   summed peak under 72 GB; (s4) the EF-int8 step on pod 2: 3 steps without
   clipping, every leaf and each pod's residual bit for bit against the
   reference's formula recomputed in one process, the wire bytes of both
   forms and the residuals' largest entry printed; (s5) (s2)'s checkpoint
   through ``survive_shrink`` onto data 1 x model 2 (its first mesh,
   (s2)'s, refused), bit-equal, then a step whose loss is (s2)'s fourth
   within 2e-3; then three cases tensor-parallel on data 1 x model 2,
   each held against one process: (s7) deepseek-v2-236b cut to its dense
   first layer (MLA's q_up, kv_up and wo as the rank's 64 heads, flash at
   (192, 128); bf16 parameters, 2 steps, held as (s3), no byte
   gathered), (s8) deepseek-v2-236b's MoE FFN held as (s1), the rank's
   half of the shared expert's width among the gradients, and (s9)
   seamless-m4t-medium uncut (fp32 parameters and compute, 512 stub
   frames, 3 steps held as (s3), no byte gathered); each case's seconds
   are printed. (s6) ``torch.distributed.run`` of the training launcher
   with ``--distributed-init --mesh-data 1`` on NCCL, a world of one:
   qwen2.5-3b at published widths cut to 1 layer (``--layers``: a
   published width with a short run; the reduced config runs on the card
   too since phase (t)), 2 steps of 4 x 512 tokens and the trainer's final
   checkpoint (about 4.7 GB).
14. (t) Flash over the rest of the reference's attention domain, after
   (s). (t1) The forward and backward kernels against their plain
   versions at the reduced configs' head dims (16, 24, 24 over 16 and 32:
   causal and not, gemma3-12b's reduced window of 16 across tile edges, G
   1 and G > 1), each without a cap and under logit softcaps of 50 and 5,
   and under both caps at 64, 96, 128 and 256, in fp32 and bf16 (forward
   within rtol = atol = 2e-5 and 2e-2, the log-sum-exp within 1e-3, the
   backward within FLASH_BWD_TOL, two launches bit-identical); MLA's
   (192, 128) must refuse a cap. (t2) gemma3-12b under Gemma 2's
   published softcap of 50: prefilled uncut on 2 x 2,048 as in (o) and one
   period trained on 2 x 2,048 as in (q), held against the plain ops as
   those are. (t3) Every registered arch's reduced config on the card:
   ``launch.serve.main([..., "--reduced"])`` (8 requests delivered),
   ``launch.train.main([..., "--reduced", "--steps", "3"])`` (the
   encoder-decoder, which the launcher's data cannot feed in either
   package, through (q)'s gradient check and 3 steps on stub frames), and
   the config's forward and loss on one batch through the kernels held
   against the plain ops, in fp32 compute (logits within 1e-3, loss within
   1e-5) and in bf16 (logits within the larger of 6e-2 and twice the plain
   bf16 forward's own distance from the plain fp32 one, loss within
   2e-3), each
   arch's seconds printed; then ``python -m repro_torch.launch.train
   --arch qwen2.5-3b --reduced --steps 3`` in a process of its own. Then
   rows 7f–7i timed: the narrow pairs forward and backward at the
   launcher's batch and at S 2,048, and gemma3-12b's prefill and training
   shapes with the cap beside without, each beside its bound, the plain
   version and SDPA.
15. (u) AdamW's kernels at dbrx-132b's expert leaf (16 x 6,144 x 10,752,
   bf16 parameters and gradients) and qwen2.5-3b's embedding (151,936 x
   2,048, fp32): ``adamw_update`` against its plain body (p, m and v bit
   for bit), ``sum_squares`` within 1e-5 of a float64 sum and the same
   bits twice, one launch and two counted; then the wrapper, the bare
   launch and the plain version of each timed beside the bound of its
   bytes (22 B an element in bf16, 28 B in fp32, and 2 or 4 B for the
   sum, at 3.35 TB/s), and the sum beside ``torch._foreach_norm`` and
   ``torch.linalg.vector_norm`` in fp32.
16. The most active descriptors one copy call received on each path
   (main, (k), (m), (n)) and the paths whose calls were cut into several
   launches; a ``kernels`` JSON line (each of the twelve kernels' launches
   summed over the main path, (k), (j), (l), (m), (n), (o), (p), (q),
   every rank of (s) and (t), and per path; flash's phase (o) and (t)
   launches by shape, the latter with and without a cap, and its times at
   the new head dims), then the ``ok`` JSON line last.

Any failure raises and the script exits non-zero without the last line.
It exits non-zero at once when no CUDA GPU is present or when the
package's sources are not next to it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_TC_OPS_PER_S = 989.4e12   # H100 SXM dense bf16 tensor cores
QUANT_OPS_PER_ELEM = 7         # abs, max, div, round, 2x clamp, mul

PAGE, KV_HEADS, HEAD_DIM, NUM_PAGES = 16, 8, 128, 8192
HEADS = 40                                # qwen3-14b query heads
ROW = PAGE * KV_HEADS * HEAD_DIM          # 16,384 floats = 64 KiB
SEQS, TOKENS, BURST = 64, 1024, 512

PREFILL_ARCH, PREFILL_LAYERS = "dbrx-132b", 2   # published widths, 2 of 40
PROMPTS, PROMPT_LEN = 4, 2048
LOGIT_TOL = 6e-2
FLASH_CASES = [  # B, S or (Sq, Sk), H, KV, D, causal, window, q scale
    (PROMPTS, PROMPT_LEN, 48, 8, 128, True, None, 1),
    (1, PROMPT_LEN, 48, 8, 128, False, None, 1),
    (1, PROMPT_LEN, 8, 8, 128, True, 64, 1),
    (2, 200, 8, 8, 64, False, None, 1),
    (2, 200, 48, 8, 64, True, 64, 1),
    (2, 200, 48, 8, 128, False, 64, 1),
    (2, 1000, 48, 8, 128, True, None, 1),    # S not a multiple of 128, G 6
    (1, 777, 8, 8, 64, True, 100, 1),        # a window across tile edges
    (2, (64, 300), 8, 2, 128, False, None, 1),   # Sq != Sk
    (2, 333, 16, 4, 128, True, None, 8),     # large logits: online rescale
    (4, 512, 16, 2, 128, True, None, 1),     # qwen2.5-3b's prefill: G 8
]
FLASH_FP32_SHAPE = (1, PROMPT_LEN, 48, 8, 128)   # B, S, H, KV, D, causal
#: The head dims of phase (o)'s families: B, S or (Sq, Sk), H, KV, D, DV,
#: causal, window.
FLASH_WIDE_CASES = [
    (2, 1024, 32, 32, 96, 96, True, None),     # phi-3-vision's prefill
    (2, 300, 8, 8, 96, 96, False, None),
    (1, 777, 8, 4, 96, 96, True, 100),
    (4, 512, 128, 128, 192, 128, True, None),  # deepseek-v2's MLA prefill
    (2, 333, 16, 16, 192, 128, True, None),
    (2, (64, 300), 8, 8, 192, 128, False, None),
    (2, 2048, 16, 8, 256, 256, True, None),    # gemma3-12b's global layers
    (2, 2048, 16, 8, 256, 256, True, 1024),    # ... and its local layers
    (2, 300, 8, 8, 256, 256, False, None),
    (1, 777, 8, 4, 256, 256, True, 100),
    (2, (64, 300), 4, 2, 256, 256, False, None),
]
#: Every (D, DV) pair the flash kernels are built for (``FLASH_SHAPES``).
FLASH_DIMS = ((16, 16), (24, 24), (24, 16), (32, 32), (64, 64), (96, 96),
              (128, 128), (192, 128), (256, 256))
#: The timed: (label, B, S, H, KV, D, DV, window), causal, bf16.
FLASH_WIDE_TIMED = [("phi-3-vision-4.2b", 2, 1024, 32, 32, 96, 96, None),
                    ("deepseek-v2-236b", 4, 512, 128, 128, 192, 128, None),
                    ("gemma3-12b", 2, 2048, 16, 8, 256, 256, None),
                    ("gemma3-12b local", 2, 2048, 16, 8, 256, 256, 1024)]


@contextlib.contextmanager
def recording_tables(np, sizes: dict):
    """Record in ``sizes`` the most active descriptors that one call of
    each copy kernel's launch function received (above MAX_TABLE = 4,088 a
    call is cut into several launches). Costs a count per call: keep it
    off the timed copies."""
    from unittest import mock

    from repro_torch.kernels import descriptor_copy as dc
    from repro_torch.kernels import prefetch_pipeline as pf

    real_dc, real_pf = dc._launch_copy, pf._launch

    def record(kernel, n):
        sizes[kernel] = max(sizes.get(kernel, 0), n)

    def dc_launch(src, dst, sidx, didx):
        record("descriptor_copy",
               int(np.count_nonzero((sidx >= 0) & (didx >= 0))))
        return real_dc(src, dst, sidx, didx)

    def pf_launch(src, dst, sidx, didx, depth):
        record("prefetch_pipeline", int(sidx.size))
        return real_pf(src, dst, sidx, didx, depth)

    with mock.patch.object(dc, "_launch_copy", dc_launch), \
            mock.patch.object(pf, "_launch", pf_launch):
        yield sizes


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


def bound_ms(n_bytes: int, n_ops: int,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    """The least time for the work: bytes at the memory rate or operations
    at ``ops_per_s`` (the peak for their type), whichever is larger."""
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

#: Chain lengths around the copy kernels' descriptor tables (128, 512 and
#: 4,088 pairs by value in the launch) and above the largest, where a call
#: is cut into consecutive launches.
TABLE_NS = (1, 128, 129, 512, 513, 4088, 4089, 9000)


def check_tables(torch, np, dev, g, rng, name, counter, kernel, plain, *,
                 clamp: bool) -> None:
    """``kernel`` bit for bit against ``plain`` at every n of TABLE_NS, over
    256-byte rows (one warp per descriptor) and 4 KiB rows (the bulk-copy
    path), destinations drawn with repeats so that duplicates span blocks
    and launches, -1 on both sides; the launches must be those of the
    plain model of the launch function's host pass."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import table_launches

    rows, launches = 9000, {}
    for unit in (64, 1024):
        src = torch.randn((rows, unit), device=dev, generator=g)
        dst = torch.randn((rows, unit), device=dev, generator=g)
        for n in TABLE_NS:
            sidx = rng.integers(-1, rows, n)
            didx = rng.integers(-1, rows // 4, n)
            want = plain(sidx, didx, src, dst.clone())
            before = build.LAUNCHES[counter]
            got = kernel(sidx, didx, src, dst.clone())
            torch.cuda.synchronize()
            key = f"{unit * 4}B/{n}"
            launches[key] = build.LAUNCHES[counter] - before
            expect = len(table_launches(sidx, didx, clamp=clamp))
            equal = torch.equal(got, want)
            if not equal or launches[key] != expect:
                raise AssertionError(f"{name} at {key}: equal {equal}, "
                                     f"launches {launches[key]} (want "
                                     f"{expect})")
        del src, dst
    log({"check": f"{name}_tables", "launches": launches, "equal": True})


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
    check_tables(torch, np, dev, g, rng, "descriptor_copy", "descriptor_copy",
                 descriptor_copy, descriptor_copy_plain, clamp=False)

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
        stream = torch.cuda.current_stream().cuda_stream
        if name == "descriptor_copy":     # host streams, by value
            args = [src.data_ptr(), dst.data_ptr(), NUM_PAGES, NUM_PAGES,
                    sidx.tobytes(), didx.tobytes(), BURST, row_bytes,
                    stream]
            bare = build.launch_table
        else:                             # int32 index arrays on the card
            args = [src.data_ptr(), dst.data_ptr(), s32.data_ptr(),
                    d32.data_ptr(), BURST, ROW, 0, stream]
            bare = build.launch
        ms = time_ms(torch, wrapper)
        kernel_ms = time_ms(torch, lambda: bare(name, *args))
        # Back to back, the launches queue up: the card's own time a call.
        kernel_b2b_ms = time_per_call_ms(torch, lambda: bare(name, *args),
                                         calls=50)
        plain_ms = time_ms(torch, plain)
        library_ms = None
        if name == "descriptor_copy":
            library_ms = time_ms(torch, lambda: dst.index_copy_(
                0, d_dev, src.index_select(0, s_dev)))
        b_ms, b_by = bound_ms(moved, ops)
        out[name] = {"max_abs_err": errs[name], "ms": ms,
                     "kernel_ms": kernel_ms, "kernel_b2b_ms": kernel_b2b_ms,
                     "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": moved}
        log({"time": name, "rows": BURST, "row_bytes": row_bytes,
             **out[name], "share_of_bound": b_ms / ms,
             "kernel_share_of_bound": b_ms / kernel_ms})
    del src, dst
    torch.cuda.empty_cache()
    return out


def check_prefetch(torch, np, dev, rng) -> dict:
    """``prefetched_chain_copy`` against its plain version, and its times."""
    from repro_torch.core.speculation import DEFAULT_POLICY, static_depth
    from repro_torch.kernels import build
    from repro_torch.kernels.prefetch_pipeline import (
        prefetched_chain_copy, prefetched_chain_copy_plain)

    depth_main = static_depth(DEFAULT_POLICY)     # what the op resolves
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def indices(rows, n):
        """n descriptors; duplicate destinations and -1 on both sides."""
        sidx = rng.choice(rows, n, replace=False).astype(np.int64)
        didx = rng.choice(rows, n, replace=False).astype(np.int64)
        if n >= 64:
            didx[rng.choice(n, 16, replace=False)] = didx[0]
            sidx[rng.choice(n, 8, replace=False)] = -1
            didx[rng.choice(n, 8, replace=False)] = -1
        return sidx, didx

    depths = iter(range(2, 9))
    for dtype, rows, unit in ((torch.float32, NUM_PAGES, ROW),
                              (torch.bfloat16, 2048, ROW),
                              (torch.int32, 4096, 3), (torch.uint8, 4096, 7)):
        src = (torch.randn((rows, unit), device=dev, generator=g) * 100
               ).to(dtype)
        dst = torch.zeros((rows, unit), device=dev, dtype=dtype)
        for n in (0, 1, 3, BURST):
            depth = next(depths, 4)
            sidx, didx = indices(rows, n)
            want = prefetched_chain_copy_plain(sidx, didx, src, dst.clone())
            got = prefetched_chain_copy(sidx, didx, src, dst.clone(),
                                        depth=depth)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"prefetched_chain_copy disagrees: "
                                     f"{dtype} ({rows}, {unit}), n {n}, "
                                     f"depth {depth}")
            log({"check": "prefetched_chain_copy", "dtype": str(dtype),
                 "rows": rows, "unit": unit, "n": n, "depth": depth,
                 "equal": True})
            del want, got
        del src, dst
    pool = torch.randn((2048, ROW), device=dev, generator=g)
    sidx, didx = np.arange(0, 512), np.arange(256, 768)
    want = prefetched_chain_copy_plain(sidx, didx, pool.clone(), pool.clone())
    got = prefetched_chain_copy(sidx, didx, pool, pool, depth=4)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("prefetched_chain_copy aliased move disagrees")
    log({"check": "prefetched_chain_copy", "case": "src is dst, "
         "overlapping rows", "equal": True})
    del pool, got, want
    check_tables(torch, np, dev, g, rng, "prefetched_chain_copy",
                 "prefetch_pipeline",
                 lambda s, d, a, b: prefetched_chain_copy(
                     s, d, a, b, depth=depth_main),
                 prefetched_chain_copy_plain, clamp=True)

    # Times at the main path's shapes: a 512-row swap of 64 KiB rows out of
    # a full pool, at the default depth.
    src = torch.randn((NUM_PAGES, ROW), device=dev, generator=g)
    dst = torch.zeros((BURST, ROW), device=dev)
    sidx = rng.choice(NUM_PAGES, BURST, replace=False).astype(np.int64)
    didx = np.arange(BURST, dtype=np.int64)
    s_dev = torch.from_numpy(sidx).to(dev)
    d_dev = torch.from_numpy(didx).to(dev)
    row_bytes = ROW * 4
    moved = 2 * BURST * row_bytes
    stream = torch.cuda.current_stream().cuda_stream
    ms = time_ms(torch, lambda: prefetched_chain_copy(sidx, didx, src, dst,
                                                      depth=depth_main))
    def bare():
        build.launch_table("prefetch_pipeline", src.data_ptr(),
                           dst.data_ptr(), NUM_PAGES, BURST, sidx.tobytes(),
                           didx.tobytes(), BURST, row_bytes, depth_main,
                           stream)
    kernel_ms = time_ms(torch, bare)
    kernel_b2b_ms = time_per_call_ms(torch, bare, calls=50)
    plain_ms = time_ms(torch, lambda: prefetched_chain_copy_plain(
        sidx, didx, src, dst))
    library_ms = time_ms(torch, lambda: dst.index_copy_(
        0, d_dev, src.index_select(0, s_dev)))
    b_ms, b_by = bound_ms(moved, 0)
    out = {"max_abs_err": 0.0, "ms": ms, "kernel_ms": kernel_ms,
           "kernel_b2b_ms": kernel_b2b_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": moved}
    log({"time": "prefetched_chain_copy", "rows": BURST,
         "row_bytes": row_bytes, "depth": depth_main, **out,
         "share_of_bound": b_ms / ms, "kernel_share_of_bound": b_ms / kernel_ms})
    del src, dst
    torch.cuda.empty_cache()
    return out


def paged_inputs(torch, dev, g, dtype, b, h, kv, pool, maxp, *,
                 ragged=True):
    """q, pools, tables and lengths of a decode batch over random pages."""
    q = torch.randn((b, h, HEAD_DIM), device=dev, generator=g).to(dtype)
    kp = torch.randn((pool, PAGE, kv, HEAD_DIM), device=dev,
                     generator=g).to(dtype)
    vp = torch.randn((pool, PAGE, kv, HEAD_DIM), device=dev,
                     generator=g).to(dtype)
    tables = torch.randperm(pool, device=dev, generator=g)[:b * maxp]
    tables = tables.view(b, maxp)
    lengths = torch.full((b,), maxp * PAGE, device=dev)
    if ragged:
        lengths = torch.randint(0, maxp * PAGE + 1, (b,), device=dev,
                                generator=g)
        lengths[0], lengths[1] = 0, maxp * PAGE - 5    # empty; partial page
        pos = torch.arange(maxp, device=dev)[None, :] * PAGE
        tables = torch.where(pos < lengths[:, None], tables, -1)
        tables[1, 2] = -1                              # a hole in the length
        if int(lengths[2]) <= (maxp - 1) * PAGE:
            tables[2, -1] = 7                          # past the length
    return (q, kp, vp, tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32))


def paged_work(torch, q, kp, tables, lengths) -> tuple:
    """(bytes, operations) the decode needs for these inputs: each valid
    token's K and V row read once, q read and the output written once;
    4 * H * D operations per valid token (q.k and p.v)."""
    _, h, d = q.shape
    page, kv = kp.shape[1], kp.shape[2]
    pos = torch.arange(tables.shape[1] * page, device=q.device)
    valid = (pos[None, :] < lengths.long()[:, None]) \
        & (tables >= 0).repeat_interleave(page, dim=1)
    tokens = int(valid.sum())
    elem = q.element_size()
    n_bytes = (2 * tokens * kv * d * elem + 2 * q.numel() * elem
               + 4 * (tables.numel() + lengths.numel()))
    return n_bytes, 4 * tokens * h * d


def check_paged(torch, np, dev, rng) -> dict:
    """``paged_attention`` against its plain version, and its times."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    err = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for h, kv in ((40, 8), (8, 8)):
            args = paged_inputs(torch, dev, g, dtype, 16, h, kv, 1024, 64)
            want = paged_attention_plain(*args)
            got = paged_attention(*args)
            torch.cuda.synchronize()
            e = max_err(torch, got, want)
            lim = tol + tol * want.float().abs()
            if not bool(((got.float() - want.float()).abs() <= lim).all()) \
                    or got[0].float().any():
                raise AssertionError(f"paged_attention disagrees: {dtype} "
                                     f"H/KV {h}/{kv}, max abs err {e}")
            err = max(err, e)
            log({"check": "paged_attention", "dtype": str(dtype), "H": h,
                 "KV": kv, "max_abs_err": e, "rtol": tol, "atol": tol})
            del args, want, got

    # Times at the main path's shapes: 64 sequences of 1,024 tokens, q of
    # qwen3-14b (40 heads over 8 KV heads), fp32 pools of 8,192 pages.
    q, kp, vp, tables, lengths = paged_inputs(
        torch, dev, g, torch.float32, SEQS, HEADS, KV_HEADS, NUM_PAGES,
        TOKENS // PAGE, ragged=False)
    out_t = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    ms = time_ms(torch, lambda: paged_attention(q, kp, vp, tables, lengths))
    kernel_ms = time_ms(torch, lambda: build.launch(
        "paged_attention", q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out_t.data_ptr(), SEQS,
        KV_HEADS, HEADS // KV_HEADS, HEAD_DIM, PAGE, TOKENS // PAGE, 0,
        stream))
    plain_ms = time_ms(torch, lambda: paged_attention_plain(
        q, kp, vp, tables, lengths))
    # Yardstick (the port never calls it): gather the dense K/V through the
    # block table, then scaled_dot_product_attention over that view.
    flat = tables.long().view(-1)

    def dense():
        k = kp.index_select(0, flat).view(SEQS, TOKENS, KV_HEADS, HEAD_DIM)
        v = vp.index_select(0, flat).view(SEQS, TOKENS, KV_HEADS, HEAD_DIM)
        return k.transpose(1, 2), v.transpose(1, 2)

    kd, vd = dense()
    q4 = q.view(SEQS, HEADS, 1, HEAD_DIM)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gather_ms = time_ms(torch, dense)
    attn_ms = time_ms(torch, lambda: sdpa(q4, kd, vd, enable_gqa=True))
    yard = sdpa(q4, kd, vd, enable_gqa=True).view_as(q)
    n_bytes, n_ops = paged_work(torch, q, kp, tables, lengths)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    ours = paged_attention(q, kp, vp, tables, lengths)
    out = {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": n_bytes, "operations": n_ops}
    log({"time": "paged_attention", "B": SEQS, "H": HEADS, "KV": KV_HEADS,
         "D": HEAD_DIM, "tokens_each": TOKENS, **out,
         "share_of_bound": b_ms / ms, "kernel_share_of_bound": b_ms / kernel_ms})
    log({"yardstick": "paged_attention", "index_select_kv_ms": gather_ms,
         "sdpa_enable_gqa_ms": attn_ms, "sum_ms": gather_ms + attn_ms,
         "max_abs_diff_to_kernel": max_err(torch, ours, yard)})
    del q, kp, vp, kd, vd, out_t
    torch.cuda.empty_cache()
    return out


def main_plan(torch, dev, g):
    """A dispatch plan at the prefill's shapes: 8,192 tokens routed by a
    skewed random router to dbrx-132b's 16 experts, top-4, capacity 2,560."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity, moe_dispatch_plan

    m = get_config(PREFILL_ARCH).moe
    t = PROMPTS * PROMPT_LEN
    # A skewed router: the popular experts overflow (dropped copies) and
    # the unpopular ones leave slots empty, so both -1 rules run.
    skew = torch.linspace(-1.5, 1.5, m.num_experts, device=dev)
    probs = torch.softmax(torch.randn((t, m.num_experts), device=dev,
                                      generator=g) + skew, dim=-1)
    return moe_dispatch_plan(probs, m, capacity(t, m))


def check_moe(torch, np, dev, rng) -> dict:
    """``moe_gather`` and ``moe_combine`` against their plain versions (bit
    for bit), and their times at the prefill's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_dispatch import (
        moe_combine, moe_combine_plain, moe_gather, moe_gather_plain)

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    d = get_config(PREFILL_ARCH).d_model
    t = PROMPTS * PROMPT_LEN
    plan = main_plan(torch, dev, g)
    n = plan.token_idx.shape[0]

    def same(name, got, want, **case):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{case}")
        log({"check": name, **case, "equal": True})

    def rows(shape, dtype):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    # moe_gather: the plan's -1 pattern, all -1, no -1, fp32 and bf16, a
    # width that is not a multiple of 8 (4-byte words) and one of 7 (bytes).
    tokens = rows((t, d), torch.bfloat16)
    for kind, idx in (("plan", plan.token_idx),
                      ("all -1", torch.full_like(plan.token_idx, -1)),
                      ("no -1", plan.token_idx.clamp_min(0))):
        same("moe_gather", moe_gather(idx, tokens),
             moe_gather_plain(idx, tokens), idx=kind, dtype="bfloat16",
             T=t, d=d)
    for dtype, width in ((torch.float32, d), (torch.bfloat16, 100),
                         (torch.bfloat16, 7)):
        small = rows((1024, width), dtype)
        idx = torch.randint(-1, 1024, (4096,), device=dev, generator=g,
                            dtype=torch.int32)
        same("moe_gather", moe_gather(idx, small),
             moe_gather_plain(idx, small), idx="random", dtype=str(dtype),
             T=1024, d=width)
        del small

    # moe_combine: the plan; k = 1, 4 and 6; tokens with every copy
    # dropped; fp32 and bf16; widths that are not a multiple of 8. Row 0 is
    # NaN and read by no kept copy: it must not leak.
    expert_out = rows((n, d), torch.bfloat16)
    same("moe_combine",
         moe_combine(plan.inv_slot, plan.inv_weight, expert_out),
         moe_combine_plain(plan.inv_slot, plan.inv_weight, expert_out),
         slots="plan", dtype="bfloat16", T=t, k=plan.inv_slot.shape[1], d=d)
    for dtype, width, k in ((torch.bfloat16, d, 1), (torch.float32, d, 4),
                            (torch.bfloat16, 100, 6),
                            (torch.float32, 37, 4)):
        pool = rows((4096, width), dtype)
        pool[0] = float("nan")
        slot = torch.randint(1, 4096, (2048, k), device=dev, generator=g,
                             dtype=torch.int32)
        slot[torch.rand((2048, k), device=dev, generator=g) < 0.3] = -1
        slot[:16] = -1                                  # every copy dropped
        w = torch.rand((2048, k), device=dev, generator=g)
        got = moe_combine(slot, w, pool)
        same("moe_combine", got, moe_combine_plain(slot, w, pool),
             slots="random with all -1 rows", dtype=str(dtype), T=2048, k=k,
             d=width)
        if not bool(torch.isfinite(got.float()).all()) or got[:16].any():
            raise AssertionError("moe_combine read a dropped copy's row")
        del pool

    # Times at the prefill's shapes.
    stream = torch.cuda.current_stream().cuda_stream
    idx, elem = plan.token_idx, tokens.element_size()
    active = int((idx >= 0).sum())
    out_g = torch.empty((n, d), dtype=tokens.dtype, device=dev)
    g_bytes = active * d * elem + n * d * elem + 4 * n
    safe = idx.long().clamp_min(0)
    out = {}
    b_ms, b_by = bound_ms(g_bytes, 0)
    out["moe_gather"] = {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: moe_gather(idx, tokens)),
        "kernel_ms": time_ms(torch, lambda: build.launch(
            "moe_gather", tokens.data_ptr(), out_g.data_ptr(),
            idx.data_ptr(), n, d * elem, stream)),
        "plain_ms": time_ms(torch, lambda: moe_gather_plain(idx, tokens)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": g_bytes}
    yard_g = time_ms(torch, lambda: tokens.index_select(0, safe))
    log({"time": "moe_gather", "slots": n, "active": active, "d": d,
         **out["moe_gather"],
         "share_of_bound": b_ms / out["moe_gather"]["ms"],
         "kernel_share_of_bound": b_ms / out["moe_gather"]["kernel_ms"]})
    log({"yardstick": "moe_gather", "index_select_ms": yard_g,
         "note": "one call, but a -1 slot gets row 0, not zeros"})

    slot, w = plan.inv_slot, plan.inv_weight
    k = slot.shape[1]
    kept = int((slot >= 0).sum())
    out_c = torch.empty((t, d), dtype=expert_out.dtype, device=dev)
    c_bytes = kept * d * elem + t * d * elem + 8 * t * k
    b_ms, b_by = bound_ms(c_bytes, 2 * kept * d)
    out["moe_combine"] = {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: moe_combine(slot, w, expert_out)),
        "kernel_ms": time_ms(torch, lambda: build.launch(
            "moe_combine", slot.data_ptr(), w.data_ptr(),
            expert_out.data_ptr(), out_c.data_ptr(), t, d, k, 1, stream)),
        "plain_ms": time_ms(torch, lambda: moe_combine_plain(slot, w,
                                                             expert_out)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": c_bytes, "operations": 2 * kept * d}
    flat = slot.long().clamp_min(0).view(-1)
    w16 = w.to(expert_out.dtype).view(t, 1, k)

    def yard_c():
        return torch.bmm(w16, expert_out.index_select(0, flat).view(t, k, d))
    yard_ms = time_ms(torch, yard_c)
    log({"time": "moe_combine", "tokens": t, "k": k, "kept": kept, "d": d,
         **out["moe_combine"],
         "share_of_bound": b_ms / out["moe_combine"]["ms"],
         "kernel_share_of_bound": b_ms / out["moe_combine"]["kernel_ms"]})
    log({"yardstick": "moe_combine", "index_select_plus_bmm_ms": yard_ms,
         "note": "two calls, weights rounded to bf16: not one library call"})
    del tokens, expert_out, out_g, out_c
    torch.cuda.empty_cache()
    return out


def flash_work(q, k, causal: bool, v=None, window=None) -> tuple:
    """(bytes, operations) of the attention: q, k, v read once, the output
    (B, Sq, H, DV) written once; 2 * (D + DV) operations per visible
    (query, key) pair. ``v`` defaults to k's shape."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    dv = d if v is None else v.shape[-1]
    pairs = s * (s + 1) // 2 if causal and s == sk else s * sk
    if window:
        pairs = visible_pairs(s, sk, causal, window)
    kv_bytes = k.numel() * k.element_size()
    n_bytes = q.numel() * q.element_size() + kv_bytes * (1 + dv / d) \
        + b * s * h * dv * q.element_size()
    return int(n_bytes), 2 * b * h * (d + dv) * pairs


def check_flash(torch, np, dev, rng) -> dict:
    """``flash_attention`` against its plain version, and its times at the
    prefill's shapes with SDPA beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    cfg = get_config(PREFILL_ARCH)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def qkv(b, s, h, kv, d, dtype, q_scale=1, dv=None):
        sq, sk = s if isinstance(s, tuple) else (s, s)
        q = torch.randn((b, sq, h, d), device=dev, generator=g) * q_scale
        k = torch.randn((b, sk, kv, d), device=dev, generator=g)
        v = torch.randn((b, sk, kv, dv or d), device=dev, generator=g)
        return [x.to(dtype) for x in (q, k, v)]

    cases = [(b, s, h, kv, d, d, causal, window, q_scale)
             for b, s, h, kv, d, causal, window, q_scale in FLASH_CASES]
    cases += [(b, s, h, kv, d, dv, causal, window, 1)
              for b, s, h, kv, d, dv, causal, window in FLASH_WIDE_CASES]
    err = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, s, h, kv, d, dv, causal, window, q_scale in cases:
            q, k, v = qkv(b, s, h, kv, d, dtype, q_scale, dv)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            e = max_err(torch, got, want)
            lim = tol + tol * want.float().abs()
            if not bool(((got.float() - want.float()).abs() <= lim).all()):
                raise AssertionError(
                    f"flash_attention disagrees: {dtype} B {b} S {s} "
                    f"H/KV {h}/{kv} D {d} DV {dv} causal {causal} window "
                    f"{window} q scale {q_scale}, max abs err {e}")
            if dtype == torch.bfloat16:
                err = max(err, e)
            log({"check": "flash_attention", "dtype": str(dtype), "B": b,
                 "S": s, "H": h, "KV": kv, "D": d, "DV": dv,
                 "causal": causal,
                 "window": window, "q_scale": q_scale, "max_abs_err": e,
                 "rtol": tol, "atol": tol})
            del q, k, v, want, got

    # Times at the prefill's shapes: 4 prompts of 2,048 tokens, dbrx-132b's
    # 48 query heads over 8 KV heads of 128, bf16, causal.
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = qkv(PROMPTS, PROMPT_LEN, h, kv, d, torch.bfloat16)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    kernel_ms = time_ms(torch, lambda: build.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), None, PROMPTS, PROMPT_LEN, PROMPT_LEN, h, kv, d, d, 1, 0,
        1, 0.0, stream))
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v,
                                                            causal=True),
                       reps=3, warm=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                             enable_gqa=True))
    ours = flash_attention(q, k, v, causal=True)
    lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    n_bytes, n_ops = flash_work(q, k, True)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    out = {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": n_bytes, "operations": n_ops}
    log({"time": "flash_attention", "B": PROMPTS, "S": PROMPT_LEN, "H": h,
         "KV": kv, "D": d, "dtype": "bfloat16", "causal": True, **out,
         "ops_rate": "bf16 tensor cores, 989.4 TFLOP/s",
         "share_of_bound": b_ms / ms, "kernel_share_of_bound": b_ms / kernel_ms,
         "kernel_tflops": n_ops / kernel_ms / 1e9,
         "library_tflops": n_ops / library_ms / 1e9,
         "library": "scaled_dot_product_attention(is_causal, enable_gqa)",
         "max_abs_diff_to_library": max_err(torch, ours, lib),
         "ptxas": flash_ptxas(build.BUILD_LOG.get("flash_attention"))})
    check_flash_ptxas(flash_ptxas(build.BUILD_LOG.get("flash_attention")))
    del q, k, v, o, ours, lib
    out["shapes"] = [time_flash_shape(torch, qkv, spec)
                     for spec in FLASH_WIDE_TIMED]

    # The fp32 path (the CUDA-core kernel) at one smaller shape, so that its
    # time is on record.
    b, s, h, kv, d = FLASH_FP32_SHAPE
    q, k, v = qkv(b, s, h, kv, d, torch.float32)
    o = torch.empty_like(q)
    f32_ms = time_ms(torch, lambda: build.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), None, b, s, s, h, kv, d, d, 1, 0, 0, 0.0, stream))
    n_bytes, n_ops = flash_work(q, k, True)
    log({"time": "flash_attention_fp32", "B": b, "S": s, "H": h, "KV": kv,
         "D": d, "dtype": "float32", "causal": True, "kernel_ms": f32_ms,
         "kernel_tflops": n_ops / f32_ms / 1e9,
         "bound_ms": bound_ms(n_bytes, n_ops)[0],
         "ops_rate": "fp32 outside the tensor cores, 67 TFLOP/s"})
    del q, k, v, o
    torch.cuda.empty_cache()
    return out


def sdpa_backends(torch, call, build: bool = False) -> dict:
    """``call()`` timed under each SDPA backend that takes it, by name; the
    others by their refusal. With ``build``, ``call()`` runs under the
    backend and returns what is timed (a backward over the graph that
    forward recorded, which keeps its backend)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        name = backend.name.lower()
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # a refusal's reasons
                fn = call() if build else call
                out[name] = None if build else time_ms(torch, fn)
            if build:
                out[name] = time_ms(torch, fn)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"refused: {str(e)[:160]}"
        fn = None
        torch.cuda.empty_cache()
    return out


def time_flash_shape(torch, qkv, spec) -> dict:
    """``flash_attention`` at one of phase (o)'s head dims, causal, bf16
    (windowed where ``spec`` says): the wrapper, the bare launch, the plain
    version and SDPA (which takes a value head dim that differs through its
    math or memory-efficient backend), beside the bound. With a window, or
    at a head dim of 256, SDPA is timed under each backend that takes the
    call (a window as a boolean mask) and the fastest is its time."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    label, b, s, h, kv, d, dv, window = spec
    q, k, v = qkv(b, s, h, kv, d, torch.bfloat16, dv=dv)
    o = q.new_empty((b, s, h, dv))
    stream = torch.cuda.current_stream().cuda_stream
    ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True,
                                                window=window))
    kernel_ms = time_ms(torch, lambda: build.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), None, b, s, s, h, kv, d, dv, 1, window or 0, 1,
        0.0, stream))
    plain_ms = time_ms(torch, lambda: flash_attention_plain(
        q, k, v, causal=True, window=window), reps=3, warm=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    backends = None
    if window is None and d <= 192:
        library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
        lib = sdpa(qt, kt, vt, is_causal=True)
    else:
        from repro_torch.kernels.flash_attention import _visible
        mask = None if window is None else _visible(s, s, True, window,
                                                    q.device)
        kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
        backends = sdpa_backends(torch, lambda: sdpa(
            qt, kt, vt, enable_gqa=h != kv, **kw))
        timed = {n: t for n, t in backends.items()
                 if isinstance(t, float)}
        library_ms = min(timed.values()) if timed else None
        lib = sdpa(qt, kt, vt, enable_gqa=h != kv, **kw)
    diff = max_err(torch, flash_attention(q, k, v, causal=True,
                                          window=window), lib.transpose(1, 2))
    n_bytes, n_ops = flash_work(q, k, True, v, window)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    out = {"model": label, "B": b, "S": s, "H": h, "KV": kv, "D": d,
           "DV": dv, "causal": True, "window": window, "dtype": "bfloat16",
           "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": n_bytes, "operations": n_ops}
    log({"time": "flash_attention_shape", **out,
         "share_of_bound": b_ms / kernel_ms,
         "kernel_tflops": n_ops / kernel_ms / 1e9,
         "library_tflops": library_ms and n_ops / library_ms / 1e9,
         "library": "scaled_dot_product_attention(is_causal)"
                    if backends is None else
                    "scaled_dot_product_attention(enable_gqa, is_causal or "
                    "the window as attn_mask), the fastest backend",
         "library_ms_by_backend": backends,
         "max_abs_diff_to_library": diff})
    del q, k, v, o, lib
    torch.cuda.empty_cache()
    return out


def flash_ptxas(build_log) -> dict:
    """Registers, static shared memory and spills of each flash kernel, as
    ptxas -v reports them (the tensor-core kernel's tiles are dynamic
    shared memory, which ptxas does not see)."""
    if not build_log:
        return {"note": "library not built in this run"}
    out, name = {}, None
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            name = None
            for d, dv in FLASH_DIMS:
                dims = str(d) if d == dv else f"{d}_{dv}"
                if f"tc_kernelILi{d}ELi{dv}E" in ln:
                    # The capped instantiation's flag is true (Lb1E).
                    name = f"bf16_tc_d{dims}" + (
                        "_softcap" if f"Li{dv}ELb1E" in ln else "")
                elif f"kernelIfLi{d}ELi{dv}E" in ln:
                    name = f"fp32_d{dims}"
                if name:
                    out[name] = {}
                    break
        elif name and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[name]["stack_bytes"], out[name]["spill_store_bytes"], \
                out[name]["spill_load_bytes"] = nums[:3]
        elif name and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                out[name]["static_smem_bytes"] = int(
                    words[words.index("smem") - 2])
    return out


def check_flash_ptxas(ptxas: dict) -> None:
    """No tensor-core forward kernel spills; where the library was built
    in this run, every head-dim pair has both kernels, and every pair but
    MLA's its capped tensor-core kernel."""
    spills = {k: p for k, p in ptxas.items()
              if k.startswith("bf16_tc") and p.get("spill_store_bytes")}
    names = [str(d) if d == dv else f"{d}_{dv}" for d, dv in FLASH_DIMS]
    want = {f"{kind}{dims}" for kind in ("bf16_tc_d", "fp32_d")
            for dims in names} | {f"bf16_tc_d{dims}_softcap"
                                  for dims in names if dims != "192_128"}
    if spills or (ptxas and "note" not in ptxas and want - set(ptxas)):
        raise AssertionError(f"flash_attention: ptxas spills {spills}, "
                             f"names {sorted(ptxas)}")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

RUNTIME_KERNELS = ("descriptor_copy", "quantize_copy", "prefetch_pipeline",
                   "paged_attention")


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


def run_step(torch, name, fn, kernels, n_bytes, **extra):
    """Drive one phase without runtime tickets; check its kernels launched."""
    from repro_torch.kernels import build
    before = build.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v - before[k] for k, v in build.launch_counts().items()}
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"phase {name}: {k} was not launched")
    log({"phase": name, "ms": ms, "bytes": n_bytes, **extra,
         "launches": launches})
    return out


def main_path(torch, np, dev, rng) -> dict:
    from repro_torch.core.chain import from_segments
    from repro_torch.core.pageref import PageRef
    from repro_torch.kernels import build
    from repro_torch.kernels.descriptor_copy import descriptor_copy_plain
    from repro_torch.kernels.ops import (
        paged_attention_op, prefetched_chain_copy_op)
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.kernels.prefetch_pipeline import (
        prefetched_chain_copy_plain)
    from repro_torch.kernels.quantize_copy import quantize_copy_plain
    from repro_torch.runtime import (
        ChannelConfig, DMARuntime, SubmitRequest, default_runtime)
    from repro_torch.runtime.lowering import translate_chain
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

    q = torch.randn((SEQS, HEADS, HEAD_DIM), device=dev, generator=g)

    def decode(name, **extra):
        """One decode step over every sequence, through the kernel."""
        args = cache.kernel_args()
        n_bytes, _ = paged_work(torch, q, args[0], args[2], args[3])
        out = run_step(torch, name, lambda: paged_attention_op(q, *args),
                       ["paged_attention"], n_bytes, **extra)
        return out, args

    build.reset_launches()                    # the main path starts here

    # (f) decode over the full pool, against the plain version.
    o0, args = decode("f_decode")
    want = paged_attention_plain(q, *args)
    err = max_err(torch, o0, want)
    if not bool(((o0 - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()):
        raise AssertionError(f"decode disagrees with the plain version: "
                             f"max abs err {err}")
    log({"check": "f_decode", "max_abs_err": err, "rtol": 2e-5,
         "atol": 2e-5})
    del want, args

    def same_decode(name, **extra):
        out, _ = decode(name, **extra)
        if not torch.equal(out, o0):
            raise AssertionError(f"{name}: decode changed")
        return out

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
    # The moves wrote only free pages, and copy-defragmentation moved a
    # sequence without changing its logical KV: decode is bit-identical.
    same_decode("f_decode_after_moves")

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

    # (g) A finished request's slot is reused: sequence 8 is evicted and
    # refilled with the same tokens. Its new pages land on the holes that
    # (b) left, so it is fragmented again; remap-defragment compacts it
    # without moving a byte. The logical KV is unchanged, so decode is
    # bit-identical while every page of the sequence sits elsewhere.
    slot_g = slot_b
    k8, v8 = (torch.from_numpy(x).to(dev) for x in cache.dense_view(slot_g))
    cache.evict(slot_g)
    cache.admit(slot_g)
    for t in range(len(k8)):
        cache.append(slot_g, k8[t], v8[t])
    rate0 = cache.alloc.speculation_hit_rate(slot_g)
    remaps0 = cache.page_table.remaps
    rate = run_step(torch, "g_defragment_remap",
                    lambda: cache.defragment(slot_g, mode="remap"), [], 0,
                    hit_rate_before=rate0)
    if not rate > rate0:
        raise AssertionError(f"remap defragment left hit rate {rate}")
    log({"check": "g_defragment_remap", "hit_rate_after": rate,
         "remaps": cache.page_table.remaps - remaps0})
    same_decode("g_decode_after_refill_and_remap")
    del k8, v8

    # (h) §II-C swap-out: 8 sequences' virtual chains lowered through the
    # page table, copied K and V into cold pools by the prefetched copy.
    # Only the sources are virtual: the cold pools are addressed directly,
    # sequence n at rows n * per_seq onwards (translate_dst=False).
    swap = list(range(40, 48))
    per_seq = TOKENS // PAGE
    hot, cold_rows = [], []
    for n, s in enumerate(swap):
        phys = translate_chain(cache.chain(s), cache.page_table, ROW,
                               translate_dst=False)
        hot.append(np.asarray(phys.src, np.int64) // ROW)
        cold_rows.append(n * per_seq + np.asarray(phys.dst, np.int64) // ROW)
    hot, cold_rows = np.concatenate(hot), np.concatenate(cold_rows)
    cold = [torch.zeros((len(swap) * per_seq, ROW), device=dev)
            for _ in range(2)]
    exp = [prefetched_chain_copy_plain(hot, cold_rows, pool, c.clone())
           for pool, c in zip((kp(), vp()), cold)]

    def swap_out():
        for pool, c in zip((kp(), vp()), cold):
            prefetched_chain_copy_op(hot, cold_rows, pool, c)
    run_step(torch, "h_swap_out_prefetched", swap_out,
             ["prefetch_pipeline"], 2 * 2 * hot.size * page_bytes,
             descriptors=int(hot.size))
    for got, want in zip(cold, exp):
        if not torch.equal(got, want):
            raise AssertionError("swap-out differs from the plain version")
    for n, s in enumerate(swap):
        k, v = cache.dense_view(s)
        for c, dense in zip(cold, (k, v)):
            rows = c[n * per_seq:(n + 1) * per_seq].view(-1, KV_HEADS,
                                                         HEAD_DIM)
            if not np.array_equal(rows[:len(dense)].cpu().numpy(), dense):
                raise AssertionError(f"swap-out of sequence {s} differs "
                                     "from its dense view")
    del exp

    # (i) swap-in: evict the hot pages, decode must change; copy them back
    # through the prefetched copy, decode must be bit-identical again.
    hot_dev = torch.from_numpy(hot).to(dev)
    kp()[hot_dev] = 0
    vp()[hot_dev] = 0
    evicted, _ = decode("i_decode_evicted")
    if torch.equal(evicted, o0):
        raise AssertionError("decode did not read the evicted pages")

    def swap_in():
        for pool, c in zip((kp(), vp()), cold):
            prefetched_chain_copy_op(cold_rows, hot, c, pool)
    run_step(torch, "i_swap_in_prefetched", swap_in, ["prefetch_pipeline"],
             2 * 2 * hot.size * page_bytes, descriptors=int(hot.size))
    for pool, c in zip((kp(), vp()), cold):
        if not torch.equal(pool[hot_dev], c[torch.from_numpy(cold_rows).to(
                dev)]):
            raise AssertionError("swap-in differs from the cold pool")
    same_decode("i_decode_after_swap_in")
    del cold, evicted

    counts = build.launch_counts()            # the main path ends here
    log({"main_path_launches": counts})
    for k in RUNTIME_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    return counts


# ---------------------------------------------------------------------------
# Phase (k): the dma/mmu/transform perf sweep, gated against BENCH_perf.json
# ---------------------------------------------------------------------------

SWEEP_KERNEL = "descriptor_copy"
#: Shapes of the sweep's traffic at which (k) times descriptor_copy:
#: (workload, config). The index streams are the workload's first chain
#: before coalescing, in rows of its unit: paged_kv on dbrx-132b is 96
#: pages of 64 fp32 (256 B) over a 16,384-element pool, moe_dispatch on
#: seamless-m4t-medium 96 token rows of 8 fp32 (32 B).
SWEEP_SHAPES = (("paged_kv", "dbrx-132b"),
                ("moe_dispatch", "seamless-m4t-medium"))
SWEEP_CALLS = 200          # back-to-back calls per timing


def time_per_call_ms(torch, fn, calls: int = SWEEP_CALLS,
                     reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls of ``fn``, divided by ``calls``: resolves launches of a few µs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def first_difference(a, b, path: str = "") -> str:
    """The first key path at which two JSON values differ, or ''."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                return f"{path}/{k}"
            d = first_difference(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return ""
    return "" if a == b else f"{path} ({a!r} != {b!r})"


def sweep_path(torch, np, dev, smi: str) -> tuple:
    """(k) ``run_sweep`` on the card over every cell of the committed
    baseline, gated and held cell for cell, metrics and counters. Returns
    the launch counts and the kernel's shapes in the sweep: (config,
    workload, active descriptors, bucket, row, pool rows) -> [first index
    streams, calls]."""
    from collections import Counter
    from unittest import mock

    from repro_torch.kernels import build
    from repro_torch.kernels import descriptor_copy as dc
    from repro_torch.perf import gate, sweep

    base = json.loads((ROOT / "BENCH_perf.json").read_text())
    spec = sweep.spec_from_doc(base)
    by_workload, shapes = Counter(), {}
    current = {"cell": ("-", "-")}
    real_pass, real_copy = sweep._run_runtime_pass, \
        dc.descriptor_copy_bucketed
    real_sharded = sweep.sharded_cell_entry

    def counting_pass(arch, workload, *args, **kw):
        current["cell"] = (arch, workload)
        n0 = build.LAUNCHES[SWEEP_KERNEL]
        out = real_pass(arch, workload, *args, **kw)
        by_workload[workload] += build.LAUNCHES[SWEEP_KERNEL] - n0
        return out

    def counting_sharded(seed, mesh, cell_spec, **kw):
        current["cell"] = (cell_spec.arch, f"kv_migration/mesh{mesh}")
        n0 = build.LAUNCHES[SWEEP_KERNEL]
        out = real_sharded(seed, mesh, cell_spec, **kw)
        by_workload[current["cell"][1]] += build.LAUNCHES[SWEEP_KERNEL] - n0
        return out

    def recording_copy(sidx, didx, src, dst, *, n_bucket):
        key = (*current["cell"], int(np.sum(np.asarray(sidx) >= 0)),
               n_bucket, src.shape[1], src.shape[0])
        shapes.setdefault(key, [np.array(sidx), np.array(didx), 0])[2] += 1
        return real_copy(sidx, didx, src, dst, n_bucket=n_bucket)

    launch_us = {}
    build.reset_launches()                    # the sweep path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(sweep, "_run_runtime_pass", counting_pass), \
            mock.patch.object(sweep, "sharded_cell_entry",
                              counting_sharded), \
            mock.patch.object(dc, "descriptor_copy_bucketed",
                              recording_copy):
        doc = sweep.run_sweep(spec, device=dev, launch_us=launch_us)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = build.launch_counts()            # the sweep path ends here

    regressions = gate.compare(base, doc)     # a GateError fails the smoke
    if regressions:
        raise AssertionError("phase k: " + "; ".join(
            r.message for r in regressions))
    equal = counters_equal = 0
    for key, cell in sorted(base["cells"].items()):
        got = doc["cells"].get(key)
        if got is None:
            raise AssertionError(f"phase k: cell {key} missing")
        diff = first_difference(got["metrics"], cell["metrics"],
                                f"{key}/metrics")
        if not diff:
            diff = first_difference(got.get("counters"),
                                    cell.get("counters"), f"{key}/counters")
            counters_equal += not diff
        if diff:
            raise AssertionError(f"phase k: differs from BENCH_perf.json at "
                                 f"{diff}")
        equal += 1
    if set(doc["cells"]) != set(base["cells"]):
        raise AssertionError("phase k: the sweep's cells are not the "
                             "baseline's")
    log({"check": "k_sweep_vs_BENCH_perf", "cells_equal": equal,
         "cells": len(base["cells"]), "counters_equal": counters_equal,
         "kinds": dict(Counter(c["kind"] for c in doc["cells"].values())),
         "gate_regressions": 0, "gate_errors": 0, "seconds": seconds,
         "runtime_passes": len(launch_us) * spec.repeats})
    if counts[SWEEP_KERNEL] <= 0:
        raise AssertionError(f"phase k: {SWEEP_KERNEL} was not launched")
    log({"k_launches": counts, "descriptor_copy_by_workload":
         dict(by_workload),
         "descriptor_copy_shapes": [
             {"config": a, "workload": w, "descriptors": n, "bucket": nb,
              "row_fp32": unit, "pool_rows": rows, "launches": c}
             for (a, w, n, nb, unit, rows), (_, _, c) in sorted(
                 shapes.items())]})
    per_workload = {}
    for w in spec.workloads:
        vals = [v for k, vs in launch_us.items() if k.split("/")[1] == w
                for v in vs]
        per_workload[w] = statistics.median(vals)
    log({"k_launch_us_per_descriptor_median": per_workload,
         "over": f"{len(spec.archs)} configs x {spec.repeats} repeats",
         "clock": "host wall-clock of the runtime's submit side",
         "card": smi})
    return counts, shapes


def check_sweep_drains(torch, np, dev, shapes) -> None:
    """The sweep's traffic over a random source pool: one runtime pass on
    the card per config and workload whose drains reached the kernel (and
    those of ``SWEEP_SHAPES``), held bit for bit against the CPU runtime."""
    from repro_torch.configs import get_config
    from repro_torch.perf.workloads import QUICK, WORKLOAD_NAMES, generate
    from repro_torch.runtime import ChannelConfig, DMARuntime, SubmitRequest

    # The sharded cells' drains are held in phase (m) and by
    # tests/test_torch_cuda.py; these are the dma cells' workloads.
    cells = sorted({(a, w) for a, w, *_ in shapes if w in WORKLOAD_NAMES}
                   | {(a, w) for w, a in SWEEP_SHAPES})
    g = torch.Generator().manual_seed(1)
    for arch, workload in cells:
        wl = generate(workload, get_config(arch), QUICK, 0)
        src = torch.randn(wl.pool_elems, generator=g)
        out = []
        for d in ("cpu", dev):
            rt = DMARuntime([ChannelConfig(name=f"ch{i}", tier="serial",
                                           ring_capacity=QUICK.ring_capacity,
                                           max_len=QUICK.max_len)
                             for i in range(4)], device=d)
            rt.register_pool("src", src.to(rt.device))
            rt.register_pool("dst", torch.zeros(wl.pool_elems,
                                                device=rt.device))
            for c in wl.chains:
                rt.submit(SubmitRequest(chain=c, src_pool="src",
                                        dst_pool="dst", tier="serial"))
            rt.drain_until_idle()
            out.append(rt.pool("dst").cpu())
        if not torch.equal(out[0], out[1]):
            raise AssertionError(f"phase k: {arch}/{workload} drains differ "
                                 "between the card and the CPU")
    log({"check": "k_drains_card_vs_cpu", "cells": [f"{a}/{w}"
                                                    for a, w in cells],
         "equal": True})


#: (m)'s drain, timed in (k) beside the sweep's shapes: (descriptors, row
#: fp32, pool rows): a page of 16 KiB cut at the runtime's max_len of 1,024
#: (M_MAX_LEN) into 4 descriptors of 4 KiB, out of one shard's pool of
#: 4,096 pages (16,384 rows of 4 KiB).
M_DRAIN_SHAPE = (4, 1024, 16384)


def time_sweep_copies(torch, np, dev, shapes) -> dict:
    """descriptor_copy at the sweep's small rows and at (m)'s drain: the
    wrapper, the bare launch function (its host pass and launch), the same
    with one descriptor (the launch floor), the plain version and
    index_select + index_copy_."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.descriptor_copy import (
        descriptor_copy_bucketed, descriptor_copy_plain, pad_bucket)
    from repro_torch.perf.workloads import QUICK, generate

    cases = []
    for workload, arch in SWEEP_SHAPES:
        wl = generate(workload, get_config(arch), QUICK, 0)
        c = wl.chains[0]
        unit = int(np.asarray(c.length)[0])
        n = c.num_descriptors
        sidx, didx = pad_bucket(np.asarray(c.src) // unit,
                                np.asarray(c.dst) // unit,
                                1 << max(n - 1, 0).bit_length())
        cases.append((f"{workload}/{arch}", sidx, didx, unit,
                      wl.pool_elems // unit))
    if shapes:                                # the shape the sweep ran most
        (a, w, _, _, unit, rows), (sidx, didx, _) = max(
            shapes.items(), key=lambda kv: kv[1][2])
        cases.append((f"{w}/{a}, as the sweep ran it", sidx, didx, unit,
                      rows))
    n, unit, rows = M_DRAIN_SHAPE
    g = np.random.default_rng(3)
    cases.append(("m drain (qwen2.5-3b pages, max_len 1,024)",
                  g.choice(rows, n, replace=False).astype(np.int64),
                  g.choice(rows, n, replace=False).astype(np.int64), unit,
                  rows))
    g = torch.Generator(device=dev).manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, sidx, didx, unit, rows in cases:
        n_bucket = len(sidx)
        n = int(np.sum((sidx >= 0) & (didx >= 0)))
        src = torch.randn((rows, unit), device=dev, generator=g)
        dst = torch.zeros_like(src)
        want = descriptor_copy_plain(sidx, didx, src, dst.clone())
        got = descriptor_copy_bucketed(sidx, didx, src, dst.clone(),
                                       n_bucket=n_bucket)
        if not torch.equal(got, want):
            raise AssertionError(f"phase k: descriptor_copy at {label} "
                                 "disagrees with its plain version")
        active = (sidx >= 0) & (didx >= 0)
        s_dev = torch.from_numpy(sidx[active]).to(dev)
        d_dev = torch.from_numpy(didx[active]).to(dev)
        row_bytes = unit * 4

        def bare(s, d):
            return lambda: build.launch_table(
                SWEEP_KERNEL, src.data_ptr(), dst.data_ptr(), rows, rows,
                s.tobytes(), d.tobytes(), s.size, row_bytes, stream)
        first = np.flatnonzero(active)[:1]
        t = {
            "ms": time_per_call_ms(torch, lambda: descriptor_copy_bucketed(
                sidx, didx, src, dst, n_bucket=n_bucket)),
            "kernel_ms": time_per_call_ms(torch, bare(sidx, didx)),
            "floor_ms": time_per_call_ms(torch, bare(sidx[first],
                                                     didx[first])),
            "plain_ms": time_per_call_ms(torch, lambda: descriptor_copy_plain(
                sidx, didx, src, dst)),
            "library_ms": time_per_call_ms(torch, lambda: dst.index_copy_(
                0, d_dev, src.index_select(0, s_dev))),
        }
        moved = 2 * n * row_bytes + 2 * 4 * n    # rows + int32 indices
        b_ms, b_by = bound_ms(moved, 0)
        out[label] = {**t, "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": max_err(torch, got, want)}
        log({"time": f"k_{SWEEP_KERNEL}", "shape": label, "descriptors": n,
             "bucket": n_bucket, "row_bytes": row_bytes, "pool_rows": rows,
             "bytes": moved, **out[label], "calls_per_timing": SWEEP_CALLS,
             "kernel_over_floor": t["kernel_ms"] / t["floor_ms"],
             "library_over_kernel": t["library_ms"] / t["kernel_ms"],
             "wrapper_under_library": t["ms"] < t["library_ms"]})
        del src, dst
    return out


# ---------------------------------------------------------------------------
# Phase 4 (j): the model path
# ---------------------------------------------------------------------------

MODEL_KERNELS = ("flash_attention", "moe_gather", "moe_combine")
J_DECODE_STEPS = 4


@contextlib.contextmanager
def recording_plans(plans: list):
    """Every MoE dispatch plan the model path computes, appended to
    ``plans`` in order."""
    from unittest import mock

    from repro_torch.models import moe as moe_mod
    real_plan = moe_mod.moe_dispatch_plan

    def recording(*args):
        plans.append(real_plan(*args))
        return plans[-1]

    with mock.patch.object(moe_mod, "moe_dispatch_plan", recording):
        yield


@contextlib.contextmanager
def recording_routes(routes: list):
    """Every top-k expert choice the model path makes (the indices of
    ``models.moe.top_k``, in the plan and for the auxiliary losses),
    appended to ``routes`` in order."""
    from unittest import mock

    from repro_torch.models import moe as moe_mod
    real_top_k = moe_mod.top_k

    def recording(probs, k):
        values, idx = real_top_k(probs, k)
        routes.append(idx)
        return values, idx

    with mock.patch.object(moe_mod, "top_k", recording):
        yield


@contextlib.contextmanager
def plain_kernels(torch, plans=None, flipped=None, routes=None):
    """The model path's three ops replaced by their plain versions, here
    and nowhere in the package. With ``plans`` (an iterator), the first
    run's dispatch plans are replayed in order so that both runs route
    alike; ``flipped`` receives, per MoE layer, the token copies that the
    plain run's own plan sends to another expert or drops where the first
    run kept them (a slot index alone also moves with the queue). Under
    autograd a replayed plan's weights would belong to the first run's
    graph and cut the router's gradient: there ``routes`` (an iterator of
    ``recording_routes``' indices) replays the expert choices instead, their
    weights taken from this run's router, and ``flipped`` receives the
    copies whose expert this run's own top-k would change."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.moe_dispatch import (
        moe_combine_plain, moe_gather_plain)
    from repro_torch.models import moe as moe_mod
    real_plan = moe_mod.moe_dispatch_plan
    real_top_k = moe_mod.top_k

    def replaying(probs, m, cap):
        ours, theirs = next(plans), real_plan(probs, m, cap)
        expert = [torch.where(p.inv_slot >= 0, p.inv_slot // cap, -1)
                  for p in (ours, theirs)]
        flipped.append(int((expert[0] != expert[1]).sum()))
        return ours

    def replaying_route(probs, k):
        idx = next(routes)
        flipped.append(int((real_top_k(probs, k)[1] != idx).sum()))
        return probs.gather(-1, idx), idx

    def plain_flash(q, k, v, *, causal=True, window=None, **_):
        return flash_attention_plain(q, k, v, causal=causal, window=window)

    # Autograd differentiates the plain forwards: the plans' other streams,
    # which only the kernels' backwards read, are not passed on.
    def plain_gather(token_idx, tokens, inv_slot=None):
        return moe_gather_plain(token_idx, tokens)

    def plain_combine(inv_slot, inv_weight, expert_out, token_idx=None):
        return moe_combine_plain(inv_slot, inv_weight, expert_out)

    with contextlib.ExitStack() as stack:
        if plans is not None:
            stack.enter_context(mock.patch.object(
                moe_mod, "moe_dispatch_plan", replaying))
        if routes is not None:
            stack.enter_context(mock.patch.object(
                moe_mod, "top_k", replaying_route))
        for name, fn in (("flash_attention_op", plain_flash),
                         ("moe_gather_op", plain_gather),
                         ("moe_combine_op", plain_combine)):
            stack.enter_context(mock.patch.object(ops, name, fn))
        yield


def hold_close(torch, label: str, got, want, tol: float) -> dict:
    """``got`` within rtol = atol = ``tol`` of ``want`` everywhere, or
    raise; returns the error's numbers for the log."""
    diff = (got.float() - want.float()).abs()
    lim = tol + tol * want.float().abs()
    out = {"max_abs_err": float(diff.max()), "rtol": tol, "atol": tol,
           "out_of_tolerance": int((diff > lim).sum()),
           "worst_share_of_tolerance": float((diff / lim).max())}
    if out["out_of_tolerance"]:
        raise AssertionError(f"{label}: differs beyond rtol = atol = {tol}: "
                             f"{out}")
    return out


def hold_greedy(torch, label: str, got, want, margin_needed) -> dict:
    """Greedy tokens of logits ``got`` and ``want`` (..., V) must agree
    wherever the top-2 margin of ``want`` exceeds ``margin_needed`` (a
    number or a tensor of the top logit's shape)."""
    g, w = got.float().argmax(-1), want.float().argmax(-1)
    top2 = want.float().topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    sure = margin > margin_needed
    if not torch.equal(g[sure], w[sure]):
        raise AssertionError(f"{label}: greedy tokens differ where the "
                             "top-2 margin exceeds the tolerance")
    return {"greedy": g.tolist(), "greedy_want": w.tolist(),
            "top2_margin": margin.tolist(), "checked": int(sure.sum()),
            "of": sure.numel()}


def clone_state(torch, state):
    """A copy of a decode state: decode steps write their caches in place."""
    from repro_torch.models import DecodeState
    from repro_torch.models.attention import KVCacheView

    def clone(c):
        return KVCacheView(*(x.clone() for x in c))

    return DecodeState({"prefix": [clone(c) for c in state.caches["prefix"]],
                        "slots": tuple(clone(c)
                                       for c in state.caches["slots"])},
                       state.cur_pos.clone())


def expect_launches(label: str, launches: dict, want: dict) -> None:
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"phase {label}: {name} launched {n} "
                                 f"times, expected {want.get(name, 0)}")


ADAMW_KERNELS = ("adamw_update", "sum_squares")


def adamw_launches(params, steps: int) -> dict:
    """AdamW's launches in ``steps`` train steps of ``params``: the
    update once a non-empty leaf, the sum of squares once a leaf and once
    more for the tree's norm."""
    from repro_torch.tree import leaves
    n = sum(1 for x in leaves(params) if x.numel())
    return {"adamw_update": n * steps, "sum_squares": (n + 1) * steps}


def prefill_path(torch, np, dev, rng, seed: int) -> tuple:
    """dbrx-132b at full width, 2 layers: forward through the three
    kernels, held against the same forward on their plain versions; then
    prefill and greedy decode steps on the same weights. Returns the
    launches of the prefill path and of the decode path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(get_config(PREFILL_ARCH),
                              num_layers=PREFILL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log({"init": PREFILL_ARCH, "layers": cfg.num_layers,
         "d_model": cfg.d_model, "heads": cfg.num_heads,
         "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim_,
         "experts": cfg.moe.num_experts, "top_k": cfg.moe.experts_per_token,
         "expert_d_ff": cfg.moe.expert_d_ff, "vocab": cfg.padded_vocab,
         "params": n_params,
         "param_bytes": sum(x.numel() * x.element_size()
                            for x in _leaves(params)),
         "seconds": time.perf_counter() - t0})
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PROMPTS, PROMPT_LEN)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}
    n_tok = PROMPTS * PROMPT_LEN

    plans = []
    build.reset_launches()                    # the model path starts here
    with recording_plans(plans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux, _, _ = forward(params, batch, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = build.launch_counts()          # the model path ends here
    expect_launches("j", launches, {k: cfg.num_layers for k in MODEL_KERNELS})
    if logits.shape != (PROMPTS, PROMPT_LEN, cfg.padded_vocab) \
            or logits.dtype != cfg.cdtype:
        raise AssertionError(f"phase j: logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    if not bool(torch.isfinite(logits).all()) or not bool(aux.isfinite()):
        raise AssertionError("phase j: logits or aux not finite")
    dropped = [int(p.num_dropped) for p in plans]
    empty = [int((p.token_idx < 0).sum()) for p in plans]
    if len(plans) != cfg.num_layers or min(dropped) <= 0 or min(empty) <= 0:
        raise AssertionError(f"phase j: dropped {dropped}, empty slots "
                             f"{empty}: both -1 rules must run")
    log({"phase": "j_prefill_dbrx_132b", "ms": ms,
         "tokens_per_s": n_tok / (ms / 1e3), "prompts": PROMPTS,
         "prompt_len": PROMPT_LEN, "dropped_tokens": dropped,
         "empty_slots": empty,
         "slots": [int(p.token_idx.shape[0]) for p in plans],
         "aux": float(aux),
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "launches": launches})

    # The same forward with the three ops replaced by their plain versions.
    # The first run's plans are replayed, so both route alike; the plain
    # run's own routing is compared.
    flipped = []
    before = build.launch_counts()
    with plain_kernels(torch, iter(plans), flipped):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_aux, _, _ = forward(params, batch, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    if build.launch_counts() != before:
        raise AssertionError("phase j: the plain forward launched a kernel")
    close = hold_close(torch, "phase j: logits against the plain forward",
                       logits, want, LOGIT_TOL)
    greedy = hold_greedy(torch, "phase j", logits[:, -1], want[:, -1],
                         LOGIT_TOL)
    log({"check": "j_prefill_vs_plain", **close,
         "copies_routed_otherwise_in_plain_run": flipped,
         "plain_ms": plain_ms,
         "aux": float(aux), "plain_aux": float(want_aux),
         "greedy_next_tokens": greedy["greedy"],
         "greedy_plain": greedy["greedy_want"],
         "top2_margin": greedy["top2_margin"]})
    del want
    steady_forward(torch, forward, params, batch, cfg, logits, n_tok)
    del logits
    decode_launches = dbrx_decode(torch, params, batch, cfg)
    del params
    torch.cuda.empty_cache()
    return {k: launches[k] for k in MODEL_KERNELS}, decode_launches


def dbrx_decode(torch, params, batch, cfg) -> dict:
    """(j) ``prefill`` and greedy ``decode_step``s on the 2-layer dbrx
    weights: ``moe_gather``/``moe_combine`` at T = 4 tokens a step, held
    step by step against the plain ops from a copy of the prefilled state,
    the dispatch plans replayed."""
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, prefill

    plans, fed, outs, step_ms = [], [], [], []
    build.reset_launches()                    # the decode path starts here
    with recording_plans(plans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, state = prefill(params, batch, cfg, PROMPT_LEN + J_DECODE_STEPS)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        start = clone_state(torch, state)
        n_prefill = len(plans)
        tok = last.argmax(-1).to(torch.int32)
        for _ in range(J_DECODE_STEPS):
            fed.append(tok)
            t0 = time.perf_counter()
            logits, state = decode_step(params, tok, state, cfg)
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits)
    launches = build.launch_counts()          # the decode path ends here
    n = cfg.num_layers
    expect_launches("j_decode", launches,
                    {"flash_attention": n,
                     "moe_gather": n * (1 + J_DECODE_STEPS),
                     "moe_combine": n * (1 + J_DECODE_STEPS)})
    flipped, wants = [], []
    before = build.launch_counts()
    state = start
    with plain_kernels(torch, iter(plans[n_prefill:]), flipped):
        for tok in fed:
            logits, state = decode_step(params, tok, state, cfg)
            wants.append(logits)
    torch.cuda.synchronize()
    if build.launch_counts() != before:
        raise AssertionError("phase j: the plain decode launched a kernel")
    got, want = torch.stack(outs), torch.stack(wants)    # (steps, B, V)
    close = hold_close(torch, "phase j: decode logits against the plain "
                       "ops", got, want, LOGIT_TOL)
    greedy = hold_greedy(torch, "phase j decode", got, want, LOGIT_TOL)
    decode_plans = plans[n_prefill:]
    log({"phase": "j_decode_dbrx_132b", "prefill_ms": prefill_ms,
         "step_ms": step_ms, "batch": PROMPTS,
         "tokens_per_token_step": int(got.shape[1]),
         "slots": [int(p.token_idx.shape[0]) for p in decode_plans],
         "empty_slots": [int((p.token_idx < 0).sum()) for p in decode_plans],
         "dropped_tokens": [int(p.num_dropped) for p in decode_plans],
         "launches": launches})
    log({"check": "j_decode_vs_plain", **close,
         "copies_routed_otherwise_in_plain_run": flipped,
         "greedy_checked": greedy["checked"], "of": greedy["of"]})
    return launches


def device_profile(torch, fn, label: str, api: dict = None):
    """Device time of ``fn`` by kernel name, largest first, as
    ``[(device_us, name, calls)]``; None where the profiler sees no card.
    ``api`` (a dict) receives the count of each CUDA runtime call the host
    made (launches, copies, synchronisations)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:      # CUPTI refused: no breakdown, say so
        log({"profile": label, "error": str(e)})
        return None
    # Kernels only: an operator's row also carries the device time of the
    # kernels it launched, which would count them twice.
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
        elif api is not None and ev.key.startswith(("cuda", "cu")):
            api[ev.key] = ev.count
    rows.sort(reverse=True)
    return rows


def host_profile(fn, top: int = 12) -> dict:
    """Host time of ``fn`` by function (cProfile): its wall time, and the
    functions of the port with the most self and cumulative time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof).stats
    rows = [(f"{Path(f).name}:{ln}:{name}", tt, ct, nc)
            for (f, ln, name), (_, nc, tt, ct, _) in st.items()
            if "repro_torch" in f or "torch/" in f]

    def pick(i):
        return [{"fn": r[0], "self_ms" if i == 1 else "cum_ms": r[i] * 1e3,
                 "calls": r[3]}
                for r in sorted(rows, key=lambda r: -r[i])[:top]]
    return {"wall_ms_profiled": wall * 1e3, "by_self": pick(1),
            "by_cumulative": pick(2)}


def steady_forward(torch, forward, params, batch, cfg, first, n_tok):
    """The same forward again, set up already: its wall time, and its
    device time by kernel name where the profiler sees the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _, _, _ = forward(params, batch, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    same = bool(torch.equal(again, first))
    if not same and max_err(torch, again, first) > LOGIT_TOL:
        raise AssertionError("phase j: a second forward gave other logits")
    del again
    READINGS["j"] = StepReading(cfg, "prefill", PROMPTS, PROMPT_LEN, ms,
                                "j_prefill_steady ms, 1 forward")
    log({"phase": "j_prefill_steady", "ms": ms,
         "tokens_per_s": n_tok / (ms / 1e3), "bit_identical_to_first": same})
    rows = device_profile(torch, lambda: forward(params, batch, cfg),
                          "j_prefill_steady")
    if not rows:
        return
    total = sum(r[0] for r in rows)
    log({"profile": "j_prefill_steady", "device_ms": total / 1e3,
         "device_busy_share_of_steady_ms": total / 1e3 / ms,
         "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": n}
                 for us, k, n in rows[:14]],
         "port_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                           "calls": n, "share": us / total}
                          for us, k, n in rows
                          if "flash_attention" in k or "moe_" in k]})


# ---------------------------------------------------------------------------
# Phase (l): serving qwen2.5-3b at full width and depth
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen2.5-3b"
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_MAX_LEN = 4, 512, 640
SERVE_DECODE_STEPS = 16
#: The reference's teacher-forcing tolerance (tests/test_models_smoke.py).
TF_TOL = 8e-2
ENGINE_CAPACITY, ENGINE_MAX_LEN, ENGINE_REQUESTS = 4, 128, 8
ENGINE_PROMPT_LENS = (16, 64)
ENGINE_NEW_TOKENS, ENGINE_POLL_EVERY = 16, 3


def serve_path(torch, np, dev, rng, seed: int) -> tuple:
    """(l) qwen2.5-3b at its published config, all 36 layers: ``prefill``
    of 4 x 512 tokens through ``flash_attention``, 16 greedy
    ``decode_step``s, then a ``ServeEngine`` serving 8 requests through
    §II-D writebacks. Held against the plain prefill, the full forward
    (teacher forcing) and per-prompt prefills. Returns the launches and
    the weights, which phase (n) serves again."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.runtime import PerfProbe, SubmitRequest
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    torch.cuda.synchronize()
    log({"init": SERVE_ARCH, "layers": cfg.num_layers,
         "d_model": cfg.d_model, "heads": cfg.num_heads,
         "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim_,
         "d_ff": cfg.d_ff, "vocab": cfg.padded_vocab,
         "params": sum(x.numel() for x in _leaves(params)),
         "param_bytes": sum(x.numel() * x.element_size()
                            for x in _leaves(params)),
         "seconds": time.perf_counter() - t0})
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (SERVE_PROMPTS, SERVE_PROMPT_LEN)).astype(
            np.int32)).to(dev)
    lo, hi = ENGINE_PROMPT_LENS
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             int(rng.integers(lo, hi + 1)))]
               for _ in range(ENGINE_REQUESTS)]

    build.reset_launches()                    # the serve path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, state = prefill(params, {"tokens": tokens}, cfg, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    fed, outs, step_ms = [], [], []
    tok = last.argmax(-1).to(torch.int32)
    for _ in range(SERVE_DECODE_STEPS):
        fed.append(tok)
        t0 = time.perf_counter()
        logits, state = decode_step(params, tok, state, cfg)
        tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(logits)

    probe = PerfProbe()
    eng = ServeEngine(params, cfg, capacity=ENGINE_CAPACITY,
                      max_len=ENGINE_MAX_LEN, device=dev)
    eng.attach_probe(probe)
    for uid, prompt in enumerate(prompts):
        eng.submit(SubmitRequest(request=Request(
            uid=uid, prompt=prompt, max_new_tokens=ENGINE_NEW_TOKENS)))
    engine_ms = []
    t_engine = time.perf_counter()
    while eng.queue or any(s.busy for s in eng.slots):
        t0 = time.perf_counter()
        eng.step()                 # ends in the sampled tokens' download
        engine_ms.append((time.perf_counter() - t0) * 1e3)
        if eng.steps % ENGINE_POLL_EVERY == 0:
            eng.poll_completed()
    delivered = eng.poll_completed()
    engine_s = time.perf_counter() - t_engine
    launches = build.launch_counts()          # the serve path ends here
    peak = torch.cuda.max_memory_allocated()
    expect_launches("l", launches, {"flash_attention": cfg.num_layers})

    pc = eng.perf_counters()
    generated = sum(len(r.output) for r in delivered)
    if sorted(r.uid for r in delivered) != list(range(ENGINE_REQUESTS)) \
            or probe.serve.completions_observed != ENGINE_REQUESTS \
            or any(len(r.output) != ENGINE_NEW_TOKENS for r in delivered):
        raise AssertionError(
            f"phase l: {len(delivered)} of {ENGINE_REQUESTS} requests "
            f"delivered through their writebacks, "
            f"{probe.serve.completions_observed} observed")
    n_tok = SERVE_PROMPTS * SERVE_PROMPT_LEN
    decode_ms = statistics.median(step_ms)
    READINGS["l"] = StepReading(cfg, "prefill", SERVE_PROMPTS,
                                SERVE_PROMPT_LEN, prefill_ms,
                                "l_prefill_qwen2_5_3b ms, 1 prefill")
    log({"phase": "l_prefill_qwen2_5_3b", "ms": prefill_ms,
         "tokens_per_s": n_tok / (prefill_ms / 1e3),
         "prompts": SERVE_PROMPTS, "prompt_len": SERVE_PROMPT_LEN,
         "max_len": SERVE_MAX_LEN})
    log({"phase": "l_decode_qwen2_5_3b", "step_ms_median": decode_ms,
         "step_ms": step_ms, "batch": SERVE_PROMPTS,
         "tokens_per_s": SERVE_PROMPTS / (decode_ms / 1e3)})
    log({"phase": "l_engine_qwen2_5_3b", "requests": ENGINE_REQUESTS,
         "capacity": ENGINE_CAPACITY, "max_len": ENGINE_MAX_LEN,
         "prompt_lens": [len(p) for p in prompts],
         "max_new_tokens": ENGINE_NEW_TOKENS,
         "poll_every": ENGINE_POLL_EVERY, "steps": eng.steps,
         "step_ms_median": statistics.median(engine_ms),
         "step_ms_max": max(engine_ms), "seconds": engine_s,
         "generated_tokens": generated,
         "generated_tokens_per_s": generated / engine_s,
         "admission_stalls": pc["serve.admission_stalls"],
         "poll_latency_steps": pc["serve.completion_poll_latency_steps"],
         "request_latency_steps_p50": pc["serve.request_latency_steps_p50"],
         "request_latency_steps_p99": pc["serve.request_latency_steps_p99"],
         "delivered_in_order": [r.uid for r in delivered],
         "max_memory_allocated": peak, "launches": launches})

    # The prefill again with flash replaced by its plain version.
    before = build.launch_counts()
    with plain_kernels(torch):
        last_p, state_p = prefill(params, {"tokens": tokens}, cfg,
                                  SERVE_MAX_LEN)
    torch.cuda.synchronize()
    if build.launch_counts() != before:
        raise AssertionError("phase l: the plain prefill launched a kernel")
    close = hold_close(torch, "phase l: prefill logits against the plain "
                       "prefill", last, last_p, LOGIT_TOL)
    kv = [hold_close(torch, "phase l: prefill caches against the plain "
                     "prefill", a, b, LOGIT_TOL)["max_abs_err"]
          for c, cp in zip(state.caches["slots"], state_p.caches["slots"])
          for a, b in ((c.k[..., :SERVE_PROMPT_LEN, :, :],
                        cp.k[..., :SERVE_PROMPT_LEN, :, :]),
                       (c.v[..., :SERVE_PROMPT_LEN, :, :],
                        cp.v[..., :SERVE_PROMPT_LEN, :, :]))]
    greedy = hold_greedy(torch, "phase l prefill", last, last_p, LOGIT_TOL)
    log({"check": "l_prefill_vs_plain", **close, "kv_max_abs_err": max(kv),
         "greedy_checked": greedy["checked"], "of": greedy["of"]})
    del last_p, state_p

    # Teacher forcing: the decode steps' logits against the full forward's
    # at the same positions (flash over the sequence against the decode's
    # dense-view attention).
    seq = torch.cat([tokens, torch.stack(fed, dim=1)], dim=1)
    full, _, _, _ = forward(params, {"tokens": seq}, cfg)
    full = full[:, SERVE_PROMPT_LEN:].transpose(0, 1).contiguous()
    got = torch.stack(outs)                               # (steps, B, V)
    tf = hold_close(torch, "phase l: teacher forcing", got, full, TF_TOL)
    # A greedy token is held where the top-2 margin exceeds the tolerance,
    # or twice the largest error seen between the two routes if that is
    # more: no error of that size can flip it.
    need = max(TF_TOL, 2 * tf["max_abs_err"])
    tf_greedy = hold_greedy(torch, "phase l teacher forcing", got, full,
                            need)
    log({"check": "l_teacher_forcing", **tf, "positions": [
        SERVE_PROMPT_LEN, SERVE_PROMPT_LEN + SERVE_DECODE_STEPS - 1],
        "greedy_margin_needed": need,
        "greedy_checked": tf_greedy["checked"], "of": tf_greedy["of"]})
    del full, got, outs, seq

    # Each request's first generated token against prefill's greedy token
    # for its prompt, where the margin exceeds the same bound.
    firsts, wants = [], []
    for r in sorted(delivered, key=lambda r: r.uid):
        first, _ = prefill(params, {"tokens": torch.tensor(
            [prompts[r.uid]], dtype=torch.int32, device=dev)}, cfg,
            ENGINE_MAX_LEN)
        wants.append(first[0])
        firsts.append(r.output[0])
    want = torch.stack(wants)
    got_tok = torch.tensor(firsts, device=dev)
    g = want.float().argmax(-1)
    top2 = want.float().topk(2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > need
    if not torch.equal(got_tok[sure], g[sure]):
        raise AssertionError("phase l: an engine's first token differs from "
                             "prefill's greedy token where the margin "
                             "exceeds the tolerance")
    log({"check": "l_engine_first_token_vs_prefill",
         "greedy_margin_needed": need,
         "engine": firsts, "prefill_greedy": g.tolist(),
         "top2_margin": (top2[:, 0] - top2[:, 1]).tolist(),
         "checked": int(sure.sum()), "of": len(firsts),
         "agree": int((got_tok == g).sum())})

    # One decode step, profiled: device time by kernel name, and the share
    # of the copy kernels (the fp32 -> bf16 weight casts, mostly).
    # The host's CUDA runtime calls in the same step say where the step's
    # host time goes (kernel launches, copies, synchronisations).
    api = {}
    rows = device_profile(torch, lambda: decode_step(params, tok, state, cfg),
                          "l_decode_step", api)
    if rows:
        total = sum(r[0] for r in rows)
        cast = sum(us for us, k, _ in rows if "copy" in k.lower())
        log({"profile": "l_decode_step", "device_ms": total / 1e3,
             "device_busy_share_of_step": total / 1e3 / decode_ms,
             "copy_kernels_ms": cast / 1e3, "copy_share": cast / total,
             "kernels_launched": sum(n for _, _, n in rows),
             "cuda_api_calls": api,
             "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": n}
                     for us, k, n in rows[:12]]})
    del state, eng
    torch.cuda.empty_cache()
    return {k: launches[k] for k in MODEL_KERNELS}, params


# ---------------------------------------------------------------------------
# Phase 7 (m): cross-shard KV-page migration at a real size
# ---------------------------------------------------------------------------

#: qwen2.5-3b's published KV geometry (2 KV heads of 128), pages of 16
#: tokens, fp32: 4,096 elements (16 KiB) a page row; 4 logical shards of
#: 4,096 pages, 256 MiB a pool, K and V.
M_SHARDS, M_PAGES_PER_SHARD = 4, 4096
M_PAGE, M_KV_HEADS, M_HEAD_DIM = 16, 2, 128
M_MOVES, M_WAVE, M_TRAFFIC = 1024, 8, 4096
M_FLIP, M_LOST = 32, 3
#: Pages each kind of traffic holds when shard M_LOST is lost: live on the
#: lost shard, on hops into it, on hops out of it, and bystanders.
M_LIVE, M_INTO, M_OUT, M_BYSTAND = 64, 32, 32, 16
#: The sharded runtime's serial burst window (its default): a 4,096-element
#: page is cut into 4 descriptors of 1,024, all of one length and aligned.
M_MAX_LEN = 1024


class ShardedOracle:
    """Plain torch: the global page rows of K and V, moved by indexing."""

    def __init__(self, torch, srt, kv):
        self.torch, self.srt, self.kv = torch, srt, kv
        self.k, self.v = (self.pools(n) for n in (kv.POOL_K, kv.POOL_V))

    def pools(self, name):
        t = self.torch
        return t.cat([self.srt.pool_shard(name, s)
                      for s in range(self.srt.num_shards)]).view(
                          -1, self.kv.row_elems).clone()

    def move(self, src, dst):
        t = self.torch
        s = t.as_tensor([int(p) for p in src], device=self.k.device)
        d = t.as_tensor([int(p) for p in dst], device=self.k.device)
        self.k[d] = self.k[s]
        self.v[d] = self.v[s]

    def hold(self, label, skip=()):
        """The runtime's pools equal the oracle's, shard by shard (a lost
        shard's slots are skipped: nothing reads them any more)."""
        t, kv = self.torch, self.kv
        pps = kv.owner.pages_per_shard
        for s in range(self.srt.num_shards):
            if s in skip:
                continue
            rows = slice(s * pps, (s + 1) * pps)
            for name, want in ((kv.POOL_K, self.k), (kv.POOL_V, self.v)):
                got = self.srt.pool_shard(name, s).view(-1, kv.row_elems)
                if not t.equal(got, want[rows]):
                    raise AssertionError(f"phase m ({label}): shard {s}'s "
                                         f"{name} differs from the plain "
                                         "page moves")


def sharded_path(torch, np, dev, rng, smi: str) -> dict:
    """(m) 4 logical shards on the card in qwen2.5-3b's KV geometry: 1,024
    Zipf-hot pages migrated through the async fabric in waves of 8, an
    ownership flip of 32 pages pulled on first touch, the loss of shard 3
    with hops in flight, and an evacuate/readmit round trip; each step held
    against the plain oracle. Returns the launches."""
    from repro_torch.distributed import (
        ShardedDMARuntime, ShardedKVPool, ungraceful_resize)
    from repro_torch.kernels import build
    from repro_torch.perf.sharded_cell import (
        DEFAULT_SHARDED_SPEC, _zipf_moves)

    num_pages = M_SHARDS * M_PAGES_PER_SHARD
    srt = ShardedDMARuntime(num_shards=M_SHARDS, max_len=M_MAX_LEN,
                            device=dev)
    kv = ShardedKVPool(srt, num_pages=num_pages, page=M_PAGE,
                       kv_heads=M_KV_HEADS, head_dim=M_HEAD_DIM)
    row_bytes = kv.row_elems * 4
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    for name in (kv.POOL_K, kv.POOL_V):
        srt.register_sharded_pool(
            name, torch.randn(num_pages * kv.row_elems, device=dev,
                              generator=g), kv.owner, kv.row_elems)
    oracle = ShardedOracle(torch, srt, kv)
    src, dst = _zipf_moves(rng, num_pages, M_MOVES,
                           DEFAULT_SHARDED_SPEC.zipf_alpha, M_TRAFFIC)
    src, dst = src.tolist(), dst.tolist()
    data = [ch for rt in srt.shards for ch in rt.channels.values()
            if ch.cfg.tier == "serial"]

    def step(label, fn, pages):
        before = build.launch_counts()
        m0 = dataclasses.replace(srt.migration)
        r0, drains0 = srt.fabric.now, sum(c.stats.batches for c in data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = srt.migration
        launches = {k: v - before[k] for k, v in build.launch_counts().items()}
        d = {f: getattr(m, f) - getattr(m0, f)
             for f in ("pages", "local_pages", "cross_pages", "hops",
                       "hop_completions", "chain_in", "chain_out",
                       "fabric_inflight_rounds", "fabric_hidden_rounds")}
        if m.hop_completions != m.hops or d["hop_completions"] != d["hops"]:
            raise AssertionError(f"phase m ({label}): {m.hop_completions} "
                                 f"of {m.hops} hops written back")
        for c in data:
            if c.pending or c.ring.occupancy:
                raise AssertionError(f"phase m ({label}): {c.name} not "
                                     "drained")
        copied = (d["local_pages"] + 2 * d["cross_pages"]) * 2 * row_bytes
        log({"phase": f"m_{label}", "ms": ms, "pages": pages,
             "pages_per_s": pages / (ms / 1e3), "bytes": 2 * pages * row_bytes,
             "bytes_copied": copied, **d,
             "fabric_rounds": srt.fabric.now - r0,
             "overlap_ratio": d["fabric_hidden_rounds"]
             / max(d["fabric_inflight_rounds"], 1),
             "drains": sum(c.stats.batches for c in data) - drains0,
             "launches": launches, "card": smi})
        return out, launches

    build.reset_launches()                    # the sharded path starts here

    def migrate():
        for i in range(0, len(src), M_WAVE):
            kv.move_pages(kv.refs(src[i:i + M_WAVE]),
                          kv.refs(dst[i:i + M_WAVE]), priority=1,
                          drain=False)
        srt.pump_until_idle()
        srt.drain_until_idle()
    _, first = step("migrate", migrate, len(src))
    oracle.move(src, dst)
    oracle.hold("migrate")
    # The same migration again (idempotent: the sources are unchanged),
    # under torch.profiler (device time by kernel, CUDA runtime calls) and
    # then cProfile (host time by function): where (m)'s time goes.
    ms_first = None
    api = {}
    drains0 = sum(c.stats.batches for c in data)
    rows = device_profile(torch, migrate, "m_migrate", api)
    if rows:
        total = sum(r[0] for r in rows)
        ms_first = total / 1e3
        log({"profile": "m_migrate", "device_ms": ms_first,
             "kernels_launched": sum(n for _, _, n in rows),
             "drains": sum(c.stats.batches for c in data) - drains0,
             "cudaStreamSynchronize": api.get("cudaStreamSynchronize", 0),
             "cuda_api_calls": api,
             "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": n}
                     for us, k, n in rows[:8]]})
    log({"profile": "m_migrate_host", **host_profile(migrate),
         "device_ms": ms_first})
    oracle.hold("migrate, repeated")

    # Ownership-first: 32 pages flip to shard 1 now, their bytes follow on
    # first touch, one page at a time.
    flip_pages = kv.alloc_on(0, M_FLIP)
    homes = [kv.table.slot_of(int(p)) for p in flip_pages]
    flipped = kv.flip_ownership(flip_pages, 1)

    def touch():
        rounds = []
        for p in flipped:
            r = srt.fabric.now
            kv.ensure_resident([p])
            rounds.append(srt.fabric.now - r)
        return rounds
    rounds, _ = step("flip_first_touch", touch, M_FLIP)
    if kv.first_touch_pulls != M_FLIP \
            or any(kv.owner_of(p) != 1 for p in flipped):
        raise AssertionError("phase m: the flipped pages were not pulled "
                             "onto shard 1 once each")
    oracle.move(homes, [kv.table.slot_of(int(p)) for p in flipped])
    oracle.hold("flip_first_touch")
    log({"check": "m_first_touch_rounds", "rounds_per_pull": rounds})

    # The loss of shard 3 with hops into, out of and beside it in flight.
    live = kv.alloc_on(M_LOST, M_LIVE)
    moves = (list(zip(kv.alloc_on(0, M_INTO), kv.alloc_on(M_LOST, M_INTO)))
             + list(zip(kv.alloc_on(M_LOST, M_OUT), kv.alloc_on(2, M_OUT)))
             + list(zip(kv.alloc_on(1, M_BYSTAND),
                        kv.alloc_on(0, M_BYSTAND))))
    live_phys = [kv.table.slot_of(int(p)) for p in live]
    phys = [(kv.table.slot_of(int(a)), kv.table.slot_of(int(b)))
            for a, b in moves]

    def lose():
        plan = kv.move_pages([a for a, _ in moves], [b for _, b in moves],
                             drain=False)
        srt.pump(2)
        states = sorted(t.state for t in srt._pending_hops)
        return ungraceful_resize(kv, M_LOST), plan, states
    (remap, plan, states), _ = step("ungraceful_resize", lose,
                                    M_LIVE + M_INTO + M_OUT + M_BYSTAND)
    # The oracle works on physical slots: a hop re-routed off the lost
    # shard lands in the slot of its new page; an evacuated slot moves to
    # the slot its new page names.
    landed = [int(p) for p in remap.values()]
    rerouted = {b for _, b in phys if kv.owner.owner(b) == M_LOST}
    if plan.hop_completions != plan.hops \
            or len(landed) != len(set(landed)) \
            or any(kv.owner.owner(p) == M_LOST for p in landed) \
            or set(remap) != set(live_phys) | rerouted:
        raise AssertionError("phase m: a page of the lost shard did not "
                             "land exactly once on a survivor")
    oracle.move([a for a, _ in phys],
                [kv.table.slot_of(int(remap[b])) if b in rerouted else b
                 for _, b in phys])
    oracle.move(live_phys, [int(remap[p]) for p in live_phys])
    oracle.hold("ungraceful_resize", skip=(M_LOST,))
    log({"check": "m_resize", "tickets_in_flight": states,
         "remapped": len(remap), "landed_once": True})

    # Graceful leave and rejoin of shard 2.
    def roundtrip():
        out = kv.evacuate(2)
        kv.readmit(2)
        return out
    gone = sorted(set(kv.owner.shard_pages(2)) - set(kv._free[2]))
    evac, _ = step("evacuate_readmit", roundtrip, len(gone))
    oracle.move(gone, [evac[p] for p in gone])
    oracle.hold("evacuate_readmit", skip=(M_LOST,))
    if srt.active != [True, True, True, False]:
        raise AssertionError(f"phase m: membership {srt.active}")
    launches = build.launch_counts()          # the sharded path ends here
    if first["descriptor_copy"] <= 0 or launches["descriptor_copy"] <= 0:
        raise AssertionError("phase m: descriptor_copy was not launched")
    log({"check": "m_sharded_vs_plain", "steps": 4, "equal": True,
         "pool_bytes": 2 * num_pages * row_bytes, "shards": M_SHARDS,
         "page_row_bytes": row_bytes, "max_len": M_MAX_LEN,
         "migration": dataclasses.asdict(srt.migration),
         "fabric_rounds": srt.fabric.now, "launches": launches})
    del srt, kv, oracle
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 8 (n): sharded serving at full width
# ---------------------------------------------------------------------------

N_SHARDS, N_CAPACITY, N_MAX_LEN, N_REQUESTS = 2, 2, 128, 8
N_PROMPT_LENS, N_NEW_TOKENS, N_PAGES = (8, 32), 8, 4
#: The reference's ShardedServeEngine.perf_counters() keys
#: (src/repro/distributed/sharded_runtime.py, perf_counters).
SHARDED_COUNTER_KEYS = (
    "sharded.num_shards", "sharded.requests_per_shard",
    "sharded.remote_page_reads", "sharded.migration",
    "sharded.first_touch_pulls", "sharded.page_table_generation",
    "sharded.page_table_remaps", "sharded.pending_pages", "sharded.steps",
    "sharded.completed", "sharded.admission_stalls",
    "sharded.request_latency_steps_p50", "sharded.request_latency_steps_p99",
    "sharded.request_latency_steps", "sharded.per_shard", "translation")


def sharded_serve_path(torch, np, dev, rng, params) -> dict:
    """(n) qwen2.5-3b at its published config (phase (l)'s weights) served
    through a ShardedServeEngine over 2 logical shards: 8 requests, 4 of
    them with a KV page on the shard that loses the route, so admission
    migrates it. Held against an unsharded ServeEngine on the same
    requests. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import (
        ShardedDMARuntime, ShardedKVPool, ShardedServeEngine)
    from repro_torch.kernels import build
    from repro_torch.models import forward
    from repro_torch.runtime import PerfProbe, SubmitRequest
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(SERVE_ARCH)
    lo, hi = N_PROMPT_LENS
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             int(rng.integers(lo, hi + 1)))]
               for _ in range(N_REQUESTS)]
    srt = ShardedDMARuntime(num_shards=N_SHARDS, device=dev)
    kv = ShardedKVPool(srt, num_pages=16 * N_SHARDS * N_PAGES, page=M_PAGE,
                       kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_)
    build.reset_launches()                    # the sharded serve path starts
    eng = ShardedServeEngine(params, cfg, runtime=srt, kv_pool=kv,
                             capacity=N_CAPACITY, max_len=N_MAX_LEN)
    probe = PerfProbe()
    eng.attach_probe(probe)
    routes, pulled = [], 0
    for uid, prompt in enumerate(prompts):
        home = uid % N_SHARDS
        if uid % 2:       # one page on the shard that loses the route
            pages = kv.alloc_on(home, N_PAGES - 1) + kv.alloc_on(
                (home + 1) % N_SHARDS, 1)
            pulled += 1
        else:
            pages = kv.alloc_on(home, N_PAGES)
        t = eng.submit(SubmitRequest(request=Request(
            uid=uid, prompt=prompt, max_new_tokens=N_NEW_TOKENS,
            kv_pages=pages)))
        routes.append(t.shard)
    step_ms = []
    t_engine = time.perf_counter()
    while any(e.queue or any(s.busy for s in e.slots) for e in eng.engines):
        t0 = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if len(step_ms) % ENGINE_POLL_EVERY == 0:
            eng.poll_completed()
    delivered = {r.uid: r for r in eng.poll_completed()}
    seconds = time.perf_counter() - t_engine
    launches = build.launch_counts()          # the sharded serve path ends
    pc = eng.perf_counters()
    if sorted(delivered) != list(range(N_REQUESTS)) \
            or probe.serve.completions_observed != N_REQUESTS \
            or any(len(r.output) != N_NEW_TOKENS
                   for r in delivered.values()):
        raise AssertionError(f"phase n: {len(delivered)} of {N_REQUESTS} "
                             "requests delivered through their writebacks")
    if eng.remote_page_reads != pulled or pc["sharded.migration"][
            "hop_completions"] != pc["sharded.migration"]["hops"]:
        raise AssertionError(f"phase n: {eng.remote_page_reads} remote page "
                             f"reads, {pulled} pages had to be pulled")
    if tuple(sorted(pc)) != tuple(sorted(SHARDED_COUNTER_KEYS)):
        raise AssertionError(f"phase n: perf_counters keys {sorted(pc)} "
                             "differ from the reference's")
    if launches["descriptor_copy"] <= 0:
        raise AssertionError("phase n: the pull-in migrations never "
                             "launched descriptor_copy")
    generated = sum(len(r.output) for r in delivered.values())
    log({"phase": "n_sharded_serve_qwen2_5_3b", "shards": N_SHARDS,
         "requests": N_REQUESTS, "capacity": N_CAPACITY,
         "max_len": N_MAX_LEN, "prompt_lens": [len(p) for p in prompts],
         "max_new_tokens": N_NEW_TOKENS, "routes": routes,
         "requests_per_shard": pc["sharded.requests_per_shard"],
         "remote_page_reads": eng.remote_page_reads,
         "migration": pc["sharded.migration"], "steps": len(step_ms),
         "step_ms_median": statistics.median(step_ms),
         "step_ms_max": max(step_ms), "seconds": seconds,
         "generated_tokens": generated,
         "generated_tokens_per_s": generated / seconds,
         "launches": launches})

    # The same requests through one unsharded engine on the same weights.
    ref = ServeEngine(params, cfg, capacity=N_CAPACITY * N_SHARDS,
                      max_len=N_MAX_LEN, device=dev)
    for uid, prompt in enumerate(prompts):
        ref.submit(SubmitRequest(request=Request(
            uid=uid, prompt=prompt, max_new_tokens=N_NEW_TOKENS)))
    want = ref.run()
    # A token may differ only where the two routes' logits are a near tie:
    # at the first difference, the top-2 margin of the full forward over
    # the shared prefix must be under the tolerance; before it, the tokens
    # agree.
    agree, checked, ties = 0, 0, []
    for uid, prompt in enumerate(prompts):
        got, exp = delivered[uid].output, want[uid].output
        k = next((i for i, (a, b) in enumerate(zip(got, exp)) if a != b),
                 None)
        checked += len(got) if k is None else k
        if k is None:
            agree += 1
            continue
        seq = torch.tensor([prompt + got[:k]], dtype=torch.int32, device=dev)
        logits = forward(params, {"tokens": seq}, cfg)[0][0, -1].float()
        top2 = logits.topk(2).values
        margin = float(top2[0] - top2[1])
        ties.append({"uid": uid, "position": k, "top2_margin": margin})
        if margin > TF_TOL:
            raise AssertionError(f"phase n: request {uid}'s token {k} "
                                 "differs from the unsharded engine's where "
                                 f"the top-2 margin ({margin}) exceeds "
                                 f"{TF_TOL}")
    log({"check": "n_sharded_vs_unsharded_engine", "requests_equal": agree,
         "of": N_REQUESTS, "tokens_checked": checked,
         "greedy_margin_needed": TF_TOL, "near_ties": ties})
    del eng, ref, srt, kv
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 9 (o): every other model family at its published widths
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Family:
    arch: str
    layers: int | None      # depth cut to this many layers; None: published
    batch: int
    prompt_len: int         # decoder tokens
    steps: int              # greedy decode steps
    frames: int = 0         # encoder frames (the encoder-decoder)
    engine: bool = False    # also serve ENGINE_REQUESTS through a ServeEngine
    param_dtype: str | None = None  # the parameters' dtype, if not fp32
    read: bool = False      # phase (r) reads the timed prefill
    softcap: float | None = None  # a logit softcap the config lacks


#: deepseek-v2-236b keeps its dense layer 0 and one MoE layer of 60;
#: jamba-v0.1-52b one period of 8 of 32 (7 mamba + 1 attention, 4 MoE).
#: The dense family runs uncut, its parameters in bf16 (fp32 would take 47,
#: 59 and 63 GB): gemma3-12b's 48 layers (40 windowed at 1,024 behind a
#: prompt of 2,048, so that the kernel's window and the decode ring both
#: wrap; heads of 256), qwen3-14b's 40 (q/k norm) and starcoder2-15b's 40
#: (biases, a non-gated MLP, G 12).
FAMILIES = (
    Family("deepseek-v2-236b", 2, 4, 512, 8),
    Family("jamba-v0.1-52b", 8, 4, 512, 8),
    Family("mamba2-780m", None, 4, 512, 16, engine=True),
    Family("seamless-m4t-medium", None, 4, 128, 8, frames=512),
    Family("phi-3-vision-4.2b", None, 2, 448, 8),
    Family("gemma3-12b", None, 2, 2048, 8, param_dtype="bfloat16",
           read=True),
    Family("qwen3-14b", None, 2, 2048, 8, param_dtype="bfloat16",
           read=True),
    Family("starcoder2-15b", None, 2, 2048, 8, param_dtype="bfloat16",
           read=True),
)
#: Teacher forcing runs from a shorter prompt, so that prompt and steps
#: fill one SSD chunk of 256 (a longer pass must divide into chunks).
TF_POSITIONS = 256
#: Scale of the stub frontend embeddings (frames, patches): the token
#: embeddings' init scale.
STUB_SCALE = 0.02


def family_layers(cfg):
    """(mixer, ffn) of every decoder layer, prefix first."""
    from repro_torch.models.transformer import n_periods
    return [(cfg.block_pattern[0][0], "dense")] * cfg.first_k_dense \
        + list(cfg.block_pattern) * n_periods(cfg)


def flash_dims(cfg) -> tuple:
    """(D, DV) of the config's attention core: MLA's query/key heads over
    its value heads, else the head dim."""
    if cfg.mla is not None:
        return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim)
    return cfg.head_dim_, cfg.head_dim_


def family_launches(cfg, steps: int) -> tuple:
    """The launches two prefills (cold, then steady) and ``steps`` decode
    steps make: by kernel, and flash by shape key. Flash runs once a
    prefill per attention layer (and per encoder layer and
    cross-attention); the MoE kernels once per MoE layer per pass, decode
    steps included."""
    from collections import Counter

    from repro_torch.kernels.flash_attention import shape_key
    layers = family_layers(cfg)
    n_attn = sum(m in ("attn", "local") for m, _ in layers)
    n_moe = sum(f == "moe" for _, f in layers)
    d, dv = flash_dims(cfg)
    cap = None if cfg.mla is not None else cfg.attn_logit_softcap
    shapes = Counter({shape_key(d, dv, True, cap): 2 * n_attn})
    if cfg.is_encdec:
        shapes[shape_key(d, dv, False)] += 2 * (cfg.encoder_layers + n_attn)
    shapes = +shapes
    kernels = {"flash_attention": sum(shapes.values()),
               "moe_gather": n_moe * (2 + steps),
               "moe_combine": n_moe * (2 + steps)}
    return kernels, dict(shapes)


def family_batch(torch, np, dev, rng, cfg, spec, n_tokens: int) -> dict:
    """Token ids and the stub frontend embeddings, from ``rng``."""
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (spec.batch, n_tokens)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    if spec.frames:
        batch["frames"] = torch.randn((spec.batch, spec.frames, cfg.d_model),
                                      device=dev, generator=g) * STUB_SCALE
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.randn(
            (spec.batch, cfg.prefix_len, cfg.d_model), device=dev,
            generator=g) * STUB_SCALE
    return batch


def greedy_steps(torch, params, cfg, last, state, steps: int,
                 tokens=None) -> tuple:
    """``steps`` greedy decode steps from prefill's last logits, or with
    ``tokens`` (a list of ``steps`` (B,) tensors) those tokens fed instead:
    (fed tokens, logits per step (steps, B, V), step ms, state)."""
    from repro_torch.models import decode_step
    fed, outs, step_ms = [], [], []
    tok = last.argmax(-1).to(torch.int32)
    for i in range(steps):
        if tokens is not None:
            tok = tokens[i]
        fed.append(tok)
        t0 = time.perf_counter()
        logits, state = decode_step(params, tok, state, cfg)
        tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(logits)
    return fed, torch.stack(outs), step_ms, state


def cache_tensors(caches):
    """(name, tensor) of every decode cache field but the tags."""
    for key in ("prefix", "slots", "cross_prefix", "cross_slots"):
        for i, c in enumerate(caches.get(key, ())):
            for name, x in zip(c._fields, c):
                if name != "kv_pos" and x.numel():
                    yield f"{key}{i}.{name}", x


#: At most this share of the bf16 routes' token copies may go to other
#: experts than the fp32 forward's top-k (a near tie that rounding flips);
#: a router at fault moves most of them.
FLIP_SHARE = 0.25


def plan_experts(torch, plan, num_experts: int):
    """(T, k) expert of each token copy of a plan in which nothing drops."""
    if bool((plan.inv_slot < 0).any()):
        raise AssertionError("a teacher-forcing pass dropped a token copy")
    cap = plan.token_idx.shape[0] // num_experts
    return plan.inv_slot.long() // cap


@contextlib.contextmanager
def forced_routing(torch, experts, flipped: list):
    """Each MoE dispatch plan routes its tokens to the experts that
    ``experts`` (an iterator of (T, k) expert ids) gives in turn, gated by
    the route's own router probabilities (renormalised where the config
    says so), through the package's own plan builder; ``flipped`` receives,
    per plan, the token copies that the route's own top-k sends elsewhere."""
    from unittest import mock

    from repro_torch.models import moe as moe_mod
    real_plan, real_top_k = moe_mod.moe_dispatch_plan, moe_mod.top_k

    def forcing(probs, m, cap):
        want = next(experts).sort(-1).values
        own = real_top_k(probs, m.experts_per_token)[1].sort(-1).values
        flipped.append(int((own != want).sum()))
        # The route's own order among them: descending, ties to lower ids.
        order = torch.sort(-probs.gather(-1, want), dim=-1,
                           stable=True).indices
        want = want.gather(-1, order)
        with mock.patch.object(moe_mod, "top_k",
                               lambda p, k: (p.gather(-1, want), want)):
            return real_plan(probs, m, cap)

    with mock.patch.object(moe_mod, "moe_dispatch_plan", forcing):
        yield


def family_teacher_forcing(torch, np, dev, rng, params, cfg, spec) -> dict:
    """Decode against the full forward (teacher forcing) from a prompt of
    TF_POSITIONS - steps tokens, MoE capacity raised so that no pass drops
    a token (tests/test_models_smoke.py does the same).

    fp32 compute: greedy decode steps, the logits held within TF_TOL of
    the forward's on the same tokens.

    bf16 compute, on the fp32 run's tokens: the two schedules (a chunked
    SSD against its recurrence, flash against the dense decode view)
    round apart by more than TF_TOL over mamba2-780m's 48 layers (0.148,
    the port on the CPU), so each bf16 route is held against the fp32
    forward: the decode's logits within max(TF_TOL, 2 e), e being the
    bf16 forward's own largest error there. Rounding keeps the decode near
    e; a fault in the bf16 decode lands far beyond it. Both bf16 routes
    take the fp32 forward's experts, so that a top-k choice that rounding
    flips near a tie moves neither; the copies that their own top-k would
    have sent elsewhere are counted and held under FLIP_SHARE."""
    from repro_torch.models import forward, prefill
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    n = min(spec.prompt_len, TF_POSITIONS) - spec.steps
    batch = family_batch(torch, np, dev, rng, cfg, spec, n)
    pre = cfg.prefix_len if "prefix_embeds" in batch else 0
    positions = pre + n + spec.steps
    label = f"phase o {spec.arch}: teacher forcing"

    plans = []
    with recording_plans(plans):
        last, state = prefill(params, batch, cfg32, positions)
        n_moe = len(plans)
        fed, got32, _, state = greedy_steps(torch, params, cfg32, last,
                                            state, spec.steps)
        del state
        seq = torch.cat([batch["tokens"], torch.stack(fed, dim=1)], dim=1)
        full32, _, _, _ = forward(params, dict(batch, tokens=seq), cfg32)
    full32 = full32[:, n:].transpose(0, 1).contiguous()    # (steps, B, V)
    flips32 = routing_flips(torch, cfg, plans, n_moe, spec.steps, positions,
                            pre + n)
    tf32 = hold_close(torch, f"{label} in float32", got32, full32, TF_TOL)
    del got32

    # The fp32 forward's experts, per MoE layer (B, positions, k), fed to
    # the bf16 forward in layer order and to the bf16 decode as its prefill
    # and steps consume them.
    routes = [plan_experts(torch, p, cfg.moe.num_experts).view(
        spec.batch, positions, -1) for p in plans[n_moe * (1 + spec.steps):]]
    to_forward = [r.reshape(-1, r.shape[-1]) for r in routes]
    to_decode = [r[:, :pre + n].reshape(-1, r.shape[-1]) for r in routes] \
        + [r[:, pre + n + s] for s in range(spec.steps) for r in routes]
    flipped = {"forward": [], "decode": []}
    with forced_routing(torch, iter(to_forward), flipped["forward"]):
        full16, _, _, _ = forward(params, dict(batch, tokens=seq), cfg16)
    full16 = full16[:, n:].transpose(0, 1).contiguous()
    with forced_routing(torch, iter(to_decode), flipped["decode"]):
        last, state = prefill(params, batch, cfg16, positions)
        _, got16, _, state = greedy_steps(torch, params, cfg16, last, state,
                                          spec.steps, fed)
    del state, last
    copies = {"forward": sum(r.numel() for r in to_forward),
              "decode": sum(r.numel() for r in to_decode)}
    flip_share = {k: sum(v) / copies[k] if copies[k] else 0.0
                  for k, v in flipped.items()}
    if max(flip_share.values()) > FLIP_SHARE:
        raise AssertionError(f"{label} in bfloat16: {flip_share} of the "
                             "token copies routed otherwise than the fp32 "
                             f"forward, more than {FLIP_SHARE}")
    fwd_err = max_err(torch, full16, full32)
    tol = max(TF_TOL, 2 * fwd_err)
    tf16 = hold_close(torch, f"{label} in bfloat16 against the fp32 forward",
                      got16, full32, tol)
    need = max(TF_TOL, 2 * tf16["max_abs_err"])
    greedy = hold_greedy(torch, f"{label} in bfloat16", got16, full32, need)
    return {"prompt_len": n, "steps": spec.steps,
            "float32": {**tf32, "routing_flips": flips32},
            "bfloat16": {**tf16, "forward_max_abs_err": fwd_err,
                         "against_bf16_forward_max_abs_err":
                             max_err(torch, got16, full16),
                         "copies_routed_otherwise": {
                             k: sum(v) for k, v in flipped.items()},
                         "copies": copies,
                         "greedy_margin_needed": need,
                         "greedy_checked": greedy["checked"],
                         "of": greedy["of"]}}


def routing_flips(torch, cfg, plans, n_moe: int, steps: int, seq: int,
                  first: int):
    """Tokens whose set of experts differs between a decode step and the
    full forward at the same position, over the MoE layers: ``plans`` holds
    the prefill's ``n_moe`` plans, then ``n_moe`` a step, then the
    forward's (over ``seq`` positions; step s is position first + s).
    None without MoE layers."""
    if not n_moe:
        return None

    def experts(plan):                         # (T, k), sorted per token
        return plan_experts(torch, plan, cfg.moe.num_experts).sort(-1).values

    forward_plans = plans[n_moe * (1 + steps):]
    flips = 0
    for s in range(steps):
        for j in range(n_moe):
            dec = experts(plans[n_moe * (1 + s) + j])           # (B, k)
            fwd = experts(forward_plans[j]).view(dec.shape[0], seq, -1)
            flips += int((dec != fwd[:, first + s]).any(-1).sum())
    return flips


def family_engine(torch, np, dev, rng, params, cfg) -> dict:
    """ENGINE_REQUESTS requests through a ServeEngine (capacity
    ENGINE_CAPACITY), polled every ENGINE_POLL_EVERY steps; every request
    must be delivered through its writeback."""
    from repro_torch.runtime import PerfProbe, SubmitRequest
    from repro_torch.serve import Request, ServeEngine
    lo, hi = ENGINE_PROMPT_LENS
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             int(rng.integers(lo, hi + 1)))]
               for _ in range(ENGINE_REQUESTS)]
    probe = PerfProbe()
    eng = ServeEngine(params, cfg, capacity=ENGINE_CAPACITY,
                      max_len=ENGINE_MAX_LEN, device=dev)
    eng.attach_probe(probe)
    for uid, prompt in enumerate(prompts):
        eng.submit(SubmitRequest(request=Request(
            uid=uid, prompt=prompt, max_new_tokens=ENGINE_NEW_TOKENS)))
    engine_ms = []
    t_engine = time.perf_counter()
    while eng.queue or any(s.busy for s in eng.slots):
        t0 = time.perf_counter()
        eng.step()
        engine_ms.append((time.perf_counter() - t0) * 1e3)
        if eng.steps % ENGINE_POLL_EVERY == 0:
            eng.poll_completed()
    delivered = eng.poll_completed()
    engine_s = time.perf_counter() - t_engine
    if sorted(r.uid for r in delivered) != list(range(ENGINE_REQUESTS)) \
            or probe.serve.completions_observed != ENGINE_REQUESTS \
            or any(len(r.output) != ENGINE_NEW_TOKENS for r in delivered):
        raise AssertionError(f"phase o {cfg.name}: {len(delivered)} of "
                             f"{ENGINE_REQUESTS} requests delivered")
    generated = sum(len(r.output) for r in delivered)
    return {"requests": ENGINE_REQUESTS, "capacity": ENGINE_CAPACITY,
            "steps": eng.steps,
            "step_ms_median": statistics.median(engine_ms),
            "generated_tokens_per_s": generated / engine_s,
            "outputs": {r.uid: r.output for r in delivered},
            "prompts": prompts}


def family_run(torch, np, dev, rng, seed: int, spec: Family) -> dict:
    """One family at its published widths: prefill and greedy decode steps
    through the kernels (counted), the prefill held against the same on
    the plain ops (the dispatch plans replayed), decode against teacher
    forcing; with ``spec.engine``, a ServeEngine too, each request's first
    token held against prefill's greedy one. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import LAUNCHES_BY_SHAPE
    from repro_torch.models import init_params, prefill

    cfg = get_config(spec.arch)
    if spec.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=spec.layers)
    if spec.param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=spec.param_dtype)
    if spec.softcap is not None:
        cfg = dataclasses.replace(cfg, attn_logit_softcap=spec.softcap)
    label = spec.arch.replace("-", "_").replace(".", "_") \
        + ("_softcap" if spec.softcap is not None else "")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    torch.cuda.synchronize()
    log({"init": spec.arch, "layers": cfg.num_layers,
         "published_layers": get_config(spec.arch).num_layers,
         "param_dtype": cfg.param_dtype,
         "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
         "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
         "head_dim": cfg.head_dim_, "vocab": cfg.padded_vocab,
         "params": sum(x.numel() for x in _leaves(params)),
         "param_bytes": sum(x.numel() * x.element_size()
                            for x in _leaves(params)),
         "seconds": time.perf_counter() - t0})
    batch = family_batch(torch, np, dev, rng, cfg, spec, spec.prompt_len)
    pre = cfg.prefix_len if "prefix_embeds" in batch else 0
    positions = pre + spec.prompt_len
    max_len = positions + spec.steps + 1      # + the profiled step

    def timed_prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(params, batch, cfg, max_len)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    plans = []
    build.reset_launches()                    # the family's path starts here
    LAUNCHES_BY_SHAPE.clear()
    # The first call pays first-call costs; the second is the steady one.
    cold_prefill_ms = timed_prefill()[1]
    with recording_plans(plans):
        (last, state), prefill_ms = timed_prefill()
    _, _, step_ms, state = greedy_steps(torch, params, cfg, last, state,
                                        spec.steps)
    engine = family_engine(torch, np, dev, rng, params, cfg) \
        if spec.engine else None
    launches = build.launch_counts()          # the family's path ends here
    shapes = dict(LAUNCHES_BY_SHAPE)
    peak = torch.cuda.max_memory_allocated()
    want_k, want_shapes = family_launches(cfg, spec.steps)
    expect_launches(f"o {spec.arch}", launches, want_k)
    if shapes != want_shapes:
        raise AssertionError(f"phase o {spec.arch}: flash launched {shapes} "
                             f"by shape, expected {want_shapes}")
    if last.shape != (spec.batch, cfg.padded_vocab) \
            or not bool(torch.isfinite(last.float()).all()):
        raise AssertionError(f"phase o {spec.arch}: prefill logits "
                             f"{tuple(last.shape)} or not finite")
    decode_ms = statistics.median(step_ms)
    n_tok = spec.batch * positions
    if spec.read:
        READINGS[f"o_{label}"] = StepReading(
            cfg, "prefill", spec.batch, positions, prefill_ms,
            f"o_{label} prefill_ms")
    log({"phase": f"o_{label}", "prefill_ms": prefill_ms,
         "prefill_tokens_per_s": n_tok / (prefill_ms / 1e3),
         "cold_prefill_ms": cold_prefill_ms,
         "batch": spec.batch, "prompt_len": spec.prompt_len,
         "prefix_len": pre, "encoder_frames": spec.frames,
         "decode_steps": spec.steps, "step_ms_median": decode_ms,
         "step_ms": step_ms,
         "decode_tokens_per_s": spec.batch / (decode_ms / 1e3),
         "max_memory_allocated": peak, "launches": launches,
         "flash_launches_by_shape": shapes,
         "engine": None if engine is None else {
             k: v for k, v in engine.items()
             if k not in ("outputs", "prompts")}})

    # One more decode step, profiled: the card's busy share of a step.
    from repro_torch.models import decode_step
    tok = last.argmax(-1).to(torch.int32)
    rows = device_profile(torch, lambda: decode_step(params, tok, state, cfg),
                          f"o_{label}_decode_step")
    busy = None
    if rows:
        busy = sum(r[0] for r in rows) / 1e3 / decode_ms
        log({"profile": f"o_{label}_decode_step",
             "device_ms": sum(r[0] for r in rows) / 1e3,
             "device_busy_share_of_step": busy,
             "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": n}
                     for us, k, n in rows[:8]]})
    del state

    # The prefill again on the plain ops, the first run's plans replayed.
    flipped = []
    before = build.launch_counts()
    with plain_kernels(torch, iter(plans), flipped):
        last_p, state_p = prefill(params, batch, cfg, max_len)
    torch.cuda.synchronize()
    if build.launch_counts() != before:
        raise AssertionError(f"phase o {spec.arch}: the plain prefill "
                             "launched a kernel")
    close = hold_close(torch, f"phase o {spec.arch}: prefill logits against "
                       "the plain prefill", last, last_p, LOGIT_TOL)
    greedy = hold_greedy(torch, f"phase o {spec.arch} prefill", last, last_p,
                         LOGIT_TOL)
    _, state = prefill(params, batch, cfg, max_len)
    caches = {}
    for (name, a), (_, b) in zip(cache_tensors(state.caches),
                                 cache_tensors(state_p.caches)):
        caches[name] = hold_close(torch, f"phase o {spec.arch}: cache {name} "
                                  "against the plain prefill", a, b,
                                  LOGIT_TOL)["max_abs_err"]
    del state, state_p, last_p
    log({"check": f"o_{label}_prefill_vs_plain", **close,
         "copies_routed_otherwise_in_plain_run": flipped,
         "caches_max_abs_err": max(caches.values()), "caches": len(caches),
         "greedy_checked": greedy["checked"], "of": greedy["of"]})

    tf = family_teacher_forcing(torch, np, dev, rng, params, cfg, spec)
    log({"check": f"o_{label}_teacher_forcing", **tf})
    if engine is not None:
        # Each request's first token against prefill's greedy token for its
        # prompt, where the top-2 margin exceeds the teacher-forcing bound.
        firsts, wants = [], []
        for uid, prompt in enumerate(engine["prompts"]):
            first, _ = prefill(params, {"tokens": torch.tensor(
                [prompt], dtype=torch.int32, device=dev)}, cfg,
                ENGINE_MAX_LEN)
            wants.append(first[0])
            firsts.append(engine["outputs"][uid][0])
        want = torch.stack(wants).float()
        top2 = want.topk(2, dim=-1).values
        need = tf["bfloat16"]["greedy_margin_needed"]
        sure = top2[:, 0] - top2[:, 1] > need
        got_tok = torch.tensor(firsts, device=dev)
        if not torch.equal(got_tok[sure], want.argmax(-1)[sure]):
            raise AssertionError(f"phase o {spec.arch}: an engine's first "
                                 "token differs from prefill's greedy token "
                                 "where the margin exceeds the tolerance")
        log({"check": f"o_{label}_engine_first_token_vs_prefill",
             "engine": firsts, "prefill_greedy": want.argmax(-1).tolist(),
             "checked": int(sure.sum()), "of": len(firsts)})
    del params, last
    torch.cuda.empty_cache()
    return {"launches": launches, "flash_by_shape": shapes,
            "prefill_ms": prefill_ms, "cold_prefill_ms": cold_prefill_ms,
            "step_ms_median": decode_ms,
            "busy_share": busy, "peak_bytes": peak}


def family_path(torch, np, dev, rng, seed: int) -> dict:
    """(o) The eight families, each freed before the next. Returns the
    launches summed over them, and flash's by shape."""
    from collections import Counter
    total, shapes = Counter(), Counter()
    for spec in FAMILIES:
        t0 = time.perf_counter()
        out = family_run(torch, np, dev, rng, seed, spec)
        total.update(out["launches"])
        shapes.update(out["flash_by_shape"])
        log({"phase": f"o_{spec.arch}", "seconds": time.perf_counter() - t0})
    return dict(total), dict(shapes)


# ---------------------------------------------------------------------------
# Phase (p): training qwen2.5-3b at full width and depth
# ---------------------------------------------------------------------------

#: The flash backward kernel against its plain version: B, S, H, KV, D,
#: DV, causal, window. The first is qwen2.5-3b's training batch, the
#: eleventh deepseek-v2-236b's (its 128 MLA heads of 192 over 128), the
#: twelfth a long causal sequence, the thirteenth gemma3-12b's (heads of
#: 256 over 8) and the seventeenth phi-3-vision-4.2b's (phase (q): 576
#: patches and 512 tokens a row, 32 heads of 96), all five timed
#: (FLASH_BWD_TIMED).
FLASH_BWD_CASES = [
    (4, 512, 16, 2, 128, 128, True, None),
    (2, 512, 16, 2, 128, 128, True, 128),      # a window of 128
    (2, 384, 16, 2, 128, 128, False, None),    # not causal
    (2, 200, 6, 2, 128, 128, True, None),      # an odd group: G 3
    (2, 200, 8, 2, 64, 64, True, None),
    (2, 200, 8, 8, 96, 96, True, None),
    (2, 200, 8, 8, 192, 128, True, None),      # MLA's heads
    (2, 333, 16, 16, 192, 128, True, 100),     # ... windowed, S 333
    (2, 256, 8, 8, 192, 128, False, None),     # ... not causal
    (2, 200, 8, 2, 192, 128, True, None),      # ... summed over G 4
    (4, 512, 128, 128, 192, 128, True, None),  # deepseek-v2-236b's batch
    (1, 2048, 16, 2, 128, 128, True, None),
    (2, 2048, 16, 8, 256, 256, True, None),    # gemma3-12b's batch
    (1, 2048, 16, 8, 256, 256, True, 1024),    # ... a local layer
    (2, 300, 8, 8, 256, 256, False, None),     # ... not causal, G 1
    (1, 333, 6, 2, 256, 256, True, 100),       # ... G 3, windowed
    (4, 1088, 32, 32, 96, 96, True, None),     # phi-3-vision-4.2b's batch
]
FLASH_BWD_TIMED = (FLASH_BWD_CASES[0], FLASH_BWD_CASES[10],
                   FLASH_BWD_CASES[11], FLASH_BWD_CASES[12],
                   FLASH_BWD_CASES[16])
#: dQ, dK and dV within this share of the largest reference entry: fp32
#: sums in another order; in bf16 also the gradients' own rounding.
FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 8
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
#: The kernels' gradients against the plain ops': loss relative, global
#: norm relative, and the least cosine of any leaf's gradient.
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_MIN_COS = 2e-3, 1e-2, 0.999
#: The trainer: published widths cut to this many layers, so that a
#: checkpoint (parameters, m and v) is about 4.7 GB, not 37.
TRAINER_LAYERS, TRAINER_STEPS, TRAINER_SPLIT, TRAINER_EVERY = 1, 6, 4, 2
TRAINER_RTOL = 1e-5


@dataclasses.dataclass(frozen=True)
class StepReading:
    """One timed step of a phase, for phase (r) to read against its count."""
    cfg: object          # the ModelConfig the phase ran (depth cut and all)
    kind: str            # "train" (train_step), "grads" (loss and
                         # gradients, no AdamW) or "prefill" (forward)
    batch: int
    seq: int             # positions a row: the tokens and any patches
    ms: float            # host wall time of the step, as the phase logs it
    reading: str         # the phase's log line and key the time is from


#: Filled by phases (j), (l), (o), (p) and (q) as they run; read by (r).
READINGS: dict = {}


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through (positions from 0)."""
    n = 0
    for i in range(sq):
        hi = min(sk, i + 1) if causal else sk
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def flash_bwd_work(q, k, v, causal: bool, window) -> tuple:
    """(bytes, operations) of the backward: q, k, v, dO and the
    log-sum-exp read once, dQ, dK and dV written once (the function needs
    no output: Delta comes from P and dP); per visible
    pair 2 D (S again), 2 DV (dO V^T), 2 DV (dV), 2 D (dQ) and 2 D (dK)
    operations: 2.5 times the forward's at D = DV. (The tensor-core design
    runs S and dO V^T twice: 2 D + 2 DV more a pair.)"""
    b, sq, h, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    el = q.element_size()
    n_bytes = 2 * (q.numel() + k.numel() + v.numel()) * el \
        + b * sq * h * dv * el + b * h * sq * 4
    pairs = visible_pairs(sq, sk, causal, window)
    return int(n_bytes), 2 * b * h * pairs * (3 * d + 2 * dv)


#: The backward's kernels by name: the tensor-core design's (bf16 only;
#: ``dkdv_mla_kernel`` at MLA's (192, 128), the ``_narrow`` kernels at the
#: reduced configs' 16 to 32) first, then the CUDA-core design's (fp32
#: only).
BWD_TC_KERNELS = ("dkdv_mla_kernel", "dkdv_tc_kernel", "dq_tc_kernel",
                  "dkdv_256_kernel", "dq_256_kernel", "dkdv_narrow_kernel",
                  "dq_narrow_kernel", "lse_kernel")
#: The head-dim pairs of the narrow kernels.
NARROW_DIMS = ("16/16", "24/24", "24/16", "32/32")
BWD_KERNELS = BWD_TC_KERNELS + ("dkdv_kernel", "dq_kernel", "delta_kernel")


def bwd_kernel(name: str) -> str:
    """A backward kernel's short name from its profiled (demangled) or
    ptxas (mangled) name; the Delta passes of ``dq_tc_kernel``,
    ``dq_256_kernel`` and ``dq_narrow_kernel`` (their ``true``
    instantiations) apart from the dQ kernels."""
    kind = next((k for k in BWD_KERNELS if k in name), name[:60])
    if kind in ("dq_tc_kernel", "dq_256_kernel", "dq_narrow_kernel") \
            and ("true>" in name or "Lb1E" in name):
        return kind.replace("dq_", "delta_pass_")
    return kind


def bwd_ptxas(build_log) -> dict:
    """Registers and spills of each backward kernel, as ptxas reports
    them (empty when the library was built before this run), by kernel,
    dtype and head dims."""
    import re
    out, name = {}, None
    for ln in (build_log or "").splitlines():
        if "Compiling entry function" in ln:
            kind = next((k for k in BWD_KERNELS if k in ln), None) \
                and bwd_kernel(ln)
            dims = "/".join(re.findall(r"Li(\d+)E", ln)) \
                or ("256/256" if "_256_kernel" in ln else "")
            bf16 = "bfloat16" in ln or any(k in ln for k in BWD_TC_KERNELS)
            name = kind and f"{kind}_{'bf16' if bf16 else 'fp32'}_{dims}"
            if name:
                out[name] = {}
        elif name and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            out[name]["spill_store_bytes"] = nums[1]
        elif name and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
    return out


def check_flash_backward(torch, np, dev, rng) -> dict:
    """The backward kernel against ``flash_attention_backward_plain`` on
    the same inputs (and that against autograd of the plain forward), two
    launches bit-identical, the forward's log-sum-exp against the plain
    one; then its times at FLASH_BWD_TIMED beside its bound, SDPA's
    backward, its TFLOP/s and ptxas's registers and spills (none allowed
    in the tensor-core kernels), each through the design ``bwd_design``
    names."""
    from collections import Counter

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        LAUNCHES_BY_DESIGN, _forward, bwd_design, bwd_scratch_floats,
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def inputs(b, s, h, kv, d, dv, dtype):
        shapes = ((b, s, h, d), (b, s, kv, d), (b, s, kv, dv), (b, s, h, dv))
        return [torch.randn(x, device=dev, generator=g).to(dtype)
                for x in shapes]

    def rel(got, want):
        return [max_err(torch, a, b) / max(float(b.float().abs().max()),
                                           1e-30)
                for a, b in zip(got, want)]

    worst_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_BWD_TOL[str(dtype).split(".")[-1]]
        for b, s, h, kv, d, dv, causal, window in FLASH_BWD_CASES:
            q, k, v, dout = inputs(b, s, h, kv, d, dv, dtype)
            out, lse = _forward(q, k, v, causal, window, with_lse=True)
            _, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                             window=window, return_lse=True)
            lse_err = max_err(torch, lse, lse_p)
            want = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                                  causal=causal,
                                                  window=window)
            before = Counter(LAUNCHES_BY_DESIGN)
            got = flash_attention_backward(q, k, v, out, lse, dout,
                                           causal=causal, window=window)
            again = flash_attention_backward(q, k, v, out, lse, dout,
                                             causal=causal, window=window)
            torch.cuda.synchronize()
            ran = dict(Counter(LAUNCHES_BY_DESIGN) - before)
            want_design = "tensor_core" if dtype == torch.bfloat16 \
                else "cuda_core"
            if ran != {want_design: 2} \
                    or bwd_design(d, dv, dtype) != want_design:
                raise AssertionError(f"flash_attention_bwd at {dtype} "
                                     f"{(b, s, h, kv, d, dv)} ran the "
                                     f"designs {ran}")
            identical = all(torch.equal(a, c) for a, c in zip(got, again))
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            auto = torch.autograd.grad(flash_attention_plain(
                *leaves, causal=causal, window=window), leaves, dout)
            kernel_err, plain_err = rel(got, want), rel(want, auto)
            spec = {"dtype": str(dtype), "B": b, "S": s, "H": h, "KV": kv,
                    "D": d, "DV": dv, "causal": causal, "window": window}
            log({"check": "flash_attention_bwd", **spec, "design": ran,
                 "rel_err_dq_dk_dv": kernel_err,
                 "max_abs_err": max(max_err(torch, a, c)
                                    for a, c in zip(got, want)),
                 "plain_vs_autograd_rel_err": plain_err,
                 "lse_max_abs_err": lse_err, "tolerance": tol,
                 "bit_identical_across_launches": identical})
            if not identical:
                raise AssertionError(f"flash_attention_bwd: two launches "
                                     f"differ at {spec}")
            if max(kernel_err) > tol or max(plain_err) > tol \
                    or lse_err > 1e-3:
                raise AssertionError(f"flash_attention_bwd disagrees at "
                                     f"{spec}: {kernel_err}, plain "
                                     f"{plain_err}, lse {lse_err}")
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, max(
                    max_err(torch, a, c) for a, c in zip(got, want)))
            del q, k, v, dout, out, lse, lse_p, want, got, again, auto

    # Times at the training shape and at S 2,048: bf16, causal.
    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ptxas = bwd_ptxas(build.BUILD_LOG.get("flash_attention_bwd"))
    res, shapes = None, []
    for b, s, h, kv, d, dv, causal, window in FLASH_BWD_TIMED:
        q, k, v, dout = inputs(b, s, h, kv, d, dv, torch.bfloat16)
        out, lse = _forward(q, k, v, True, None, with_lse=True)
        dq, dk, dvv = (torch.empty_like(x) for x in (q, k, v))
        scratch = torch.empty(bwd_scratch_floats(b, s, h),
                              dtype=torch.float32, device=dev)
        designs = dict(LAUNCHES_BY_DESIGN)
        ms = time_ms(torch, lambda: flash_attention_backward(
            q, k, v, out, lse, dout, causal=True))
        design = {k_: n - designs.get(k_, 0)
                  for k_, n in LAUNCHES_BY_DESIGN.items()
                  if n != designs.get(k_, 0)}
        if set(design) != {bwd_design(d, dv, torch.bfloat16)}:
            raise AssertionError(f"flash_attention_bwd at {(b, s, h, d)} "
                                 f"ran the designs {design}")
        kernel_ms = time_ms(torch, lambda: build.launch(
            "flash_attention_bwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            b, s, s, h, kv, d, dv, 1, 0, 1, 0.0, stream))
        plain_ms = time_ms(torch, lambda: flash_attention_backward_plain(
            q, k, v, out, lse, dout, causal=True), reps=3, warm=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = dout.transpose(1, 2)
        ours = flash_attention_backward(q, k, v, out, lse, dout, causal=True)
        try:
            o_lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            library_ms = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), dot, retain_graph=True))
            lib = torch.autograd.grad(o_lib, (qt, kt, vt), dot)
            lib_diff, lib_error = max(max_err(torch, a, c.transpose(1, 2))
                                      for a, c in zip(ours, lib)), None
        except RuntimeError as e:              # SDPA refuses the shape
            o_lib = lib = library_ms = lib_diff = None
            lib_error = str(e)[:300]
        backends = None
        if d > 192:
            # The backward of each SDPA backend that takes the call; the
            # fastest is the yardstick.
            def lib_bwd():
                o_b = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
                return lambda: torch.autograd.grad(o_b, (qt, kt, vt), dot,
                                                   retain_graph=True)
            backends = sdpa_backends(torch, lib_bwd, build=True)
            timed_b = [t for t in backends.values() if isinstance(t, float)]
            if timed_b:
                library_ms = min(timed_b)
        # Device time of each of its kernels, a call (5 calls profiled).
        rows = device_profile(torch, lambda: [flash_attention_backward(
            q, k, v, out, lse, dout, causal=True) for _ in range(5)],
            f"flash_attention_bwd_{s}")
        by_kernel = {}
        for us, name, _ in rows or ():
            key = bwd_kernel(name)
            by_kernel[key] = by_kernel.get(key, 0.0) + us / 5e3
        n_bytes, n_ops = flash_bwd_work(q, k, v, True, None)
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TC_OPS_PER_S)
        # The tensor-core design's own count: S and dO V^T three times
        # (dK/dV, the Delta pass, dQ), dQ's product twice (dS split).
        ops_run = 2 * b * h * visible_pairs(s, s, True, None) \
            * (6 * d + 4 * dv)
        timed = {"max_abs_err": worst_bf16, "ms": ms,
                 "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "bytes": n_bytes, "operations": n_ops}
        log({"time": "flash_attention_bwd", "B": b, "S": s, "H": h,
             "KV": kv, "D": d, "DV": dv, "dtype": "bfloat16",
             "causal": True, **timed, "design": design,
             "ops_rate": "bf16 tensor cores, 989.4 TFLOP/s",
             "kernel_share_of_bound": b_ms / kernel_ms,
             "kernel_tflops": n_ops / kernel_ms / 1e9,
             "operations_run": ops_run,
             "kernel_tflops_run": ops_run / kernel_ms / 1e9,
             "library_tflops": library_ms and n_ops / library_ms / 1e9,
             "kernel_over_library": library_ms and kernel_ms / library_ms,
             "device_ms_by_kernel": by_kernel,
             "library": "autograd.grad of scaled_dot_product_attention("
                        "is_causal, enable_gqa)" if backends is None else
                        "the same, the fastest backend",
             "library_ms_by_backend": backends,
             "library_error": lib_error,
             "max_abs_diff_to_library": lib_diff,
             "ptxas": ptxas})
        if res is None:
            res = timed                       # the training shape's
        shapes.append({"B": b, "S": s, "H": h, "KV": kv, "D": d, "DV": dv,
                       **timed, "design": design})
        del q, k, v, dout, out, lse, dq, dk, dvv, scratch, qt, kt, vt
        del o_lib, lib, ours
        torch.cuda.empty_cache()
    check_bwd_ptxas(ptxas)
    return dict(res, shapes=shapes)


def check_bwd_ptxas(ptxas: dict) -> None:
    """No tensor-core backward kernel spills; where the library was built
    in this run, every bf16 head-dim pair has its tensor-core kernels,
    MLA's (192, 128), (256, 256) and the narrow pairs (NARROW_DIMS) their
    own, and no CUDA-core kernel is built for bf16."""
    tensor_core = BWD_TC_KERNELS + ("delta_pass_tc_kernel",
                                    "delta_pass_256_kernel",
                                    "delta_pass_narrow_kernel")
    spills = {k_: p for k_, p in ptxas.items()
              if p.get("spill_store_bytes")}
    if any(k_.startswith(tensor_core) for k_ in spills):
        raise AssertionError(f"flash_attention_bwd: ptxas spills {spills}")
    if not ptxas:
        return
    want = {"dkdv_mla_kernel_bf16_192/128", "dq_tc_kernel_bf16_192/128",
            "delta_pass_tc_kernel_bf16_192/128",
            "dkdv_256_kernel_bf16_256/256", "dq_256_kernel_bf16_256/256",
            "delta_pass_256_kernel_bf16_256/256"} | {
        f"{k_}_bf16_{d}" for d in ("64/64", "96/96", "128/128")
        for k_ in ("dkdv_tc_kernel", "dq_tc_kernel", "delta_pass_tc_kernel")
    } | {f"{k_}_bf16_{d}" for d in NARROW_DIMS
         for k_ in ("dkdv_narrow_kernel", "dq_narrow_kernel",
                    "delta_pass_narrow_kernel")}
    cuda_core_bf16 = [k_ for k_ in ptxas if k_.rsplit("_", 2)[1] == "bf16"
                      and not k_.startswith(tensor_core)]
    if want - set(ptxas) or cuda_core_bf16:
        raise AssertionError(f"flash_attention_bwd: ptxas names "
                             f"{sorted(ptxas)}; missing "
                             f"{sorted(want - set(ptxas))}, CUDA-core bf16 "
                             f"{cuda_core_bf16}")


def cosine(torch, a, b) -> float:
    """Cosine of two tensors' entries, summed in float64 in chunks."""
    a, b = a.reshape(-1), b.reshape(-1)
    ab = aa = bb = 0.0
    for i in range(0, a.numel(), 1 << 24):
        x, y = a[i:i + (1 << 24)].double(), b[i:i + (1 << 24)].double()
        ab += float(x @ y)
        aa += float(x @ x)
        bb += float(y @ y)
    return ab / max((aa * bb) ** 0.5, 1e-300)


def schedule_lr(step: int, lr: float, warmup: int, total: int,
                min_ratio: float = 0.1) -> float:
    """The cosine schedule, on the host, for holding the step's lr."""
    import math
    warm = min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return lr * warm * (min_ratio + (1 - min_ratio) * 0.5
                        * (1 + math.cos(math.pi * frac)))


def kernel_kind(name: str) -> str:
    """A profiled kernel's group in phase (p)'s and (q)'s breakdowns."""
    low = name.lower()
    if "flash_attention" in low:
        return "flash_forward"
    if any(k in low for k in BWD_KERNELS):
        return "flash_backward"
    if "moe_" in low:
        return "moe_dispatch"
    if any(k in low for k in ("gemm", "sm90_xmma", "cutlass", "nvjet")):
        return "matmul"
    if "copy" in low:
        return "copy_cast"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low or "foreach" in low:
        return "elementwise"
    return "other"


def train_path(torch, np, dev, rng, seed: int) -> dict:
    """(p) qwen2.5-3b at its published config, all 36 layers, fp32
    parameters, bf16 compute, remat "minimal": one ``grads_and_metrics``
    through the kernels held against the same on the plain ops, then
    ``TRAIN_STEPS`` train steps through ``make_train_step`` on one batch
    of the data pipeline. Returns the train steps' launches."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import LAUNCHES_BY_DESIGN
    from repro_torch.models import init_params
    from repro_torch.train import (TrainConfig, grads_and_metrics,
                                   init_state, make_train_step)
    from repro_torch.tree import flatten

    cfg = get_config(TRAIN_ARCH)
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    torch.cuda.synchronize()
    log({"init": TRAIN_ARCH, "layers": layers, "d_model": cfg.d_model,
         "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
         "head_dim": cfg.head_dim_, "vocab": cfg.padded_vocab,
         "remat_policy": cfg.remat_policy, "compute": str(cfg.cdtype),
         "params": sum(x.numel() for x in _leaves(params)),
         "seconds": time.perf_counter() - t0})
    # One batch of the data pipeline, trained on for every step: the
    # synthetic stream's tokens are uniform over 151,936 ids, so fresh
    # batches would hold the loss near ln(V) for far more than 8 steps;
    # one batch falls as the model fits it (the reference's own
    # convergence test, tests/test_substrate.py, does the same).
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH, seed=seed))
    try:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()
                 if k in ("tokens", "labels", "loss_mask")}
    finally:
        data.close()
    n_tok = TRAIN_BATCH * TRAIN_SEQ

    # The gradients through the kernels against the plain ops'.
    before = build.launch_counts()
    t0 = time.perf_counter()
    grads, m = grads_and_metrics(params, batch, cfg, 1)
    torch.cuda.synchronize()
    grads_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: n - before[k] for k, n in build.launch_counts().items()}
    expect_launches("p_grads", launched, {"flash_attention": 2 * layers,
                                          "flash_attention_bwd": layers})
    before = build.launch_counts()
    with plain_kernels(torch):
        grads_p, m_p = grads_and_metrics(params, batch, cfg, 1)
    torch.cuda.synchronize()
    if build.launch_counts() != before:
        raise AssertionError("phase p: the plain gradients launched a kernel")
    loss, loss_p = float(m["loss"]), float(m_p["loss"])
    gnorm = float(optim.global_norm(grads))
    gnorm_p = float(optim.global_norm(grads_p))
    a, b = flatten(grads), flatten(grads_p)
    cos = sorted((cosine(torch, a[k], b[k]), k) for k in b)
    ok = abs(loss - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p) \
        and abs(gnorm - gnorm_p) <= TRAIN_NORM_RTOL * gnorm_p \
        and cos[0][0] >= TRAIN_MIN_COS
    log({"check": "p_grads_vs_plain", "loss": loss, "loss_plain": loss_p,
         "loss_rel_err": abs(loss - loss_p) / abs(loss_p),
         "grad_norm": gnorm, "grad_norm_plain": gnorm_p,
         "grad_norm_rel_err": abs(gnorm - gnorm_p) / gnorm_p,
         "leaves": len(cos), "worst_leaf": cos[0][1],
         "worst_cosine": cos[0][0],
         "next_worst": [{"leaf": k, "cosine": c} for c, k in cos[1:5]],
         "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                       "grad_norm_rtol": TRAIN_NORM_RTOL,
                       "min_cosine": TRAIN_MIN_COS},
         "grads_ms_first_call": grads_ms})
    if not ok:
        raise AssertionError("phase p: the gradients through the kernels "
                             "differ from the plain ops' beyond tolerance")
    del grads, grads_p, a, b, m, m_p
    torch.cuda.empty_cache()

    # The train steps.
    ocfg = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                             total_steps=TRAIN_STEPS)
    tcfg = TrainConfig(optimizer=ocfg)
    state = init_state(params, tcfg)
    del params
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()                    # the training path starts here
    LAUNCHES_BY_DESIGN.clear()
    losses, lrs, norms, step_ms = [], [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        lrs.append(float(metrics["lr"]))
        norms.append(float(metrics["grad_norm"]))
    launches = build.launch_counts()          # the training path ends here
    designs = dict(LAUNCHES_BY_DESIGN)
    peak = torch.cuda.max_memory_allocated()
    expect_launches("p", launches,
                    {"flash_attention": 2 * layers * TRAIN_STEPS,
                     "flash_attention_bwd": layers * TRAIN_STEPS,
                     **adamw_launches(state.params, TRAIN_STEPS)})
    if designs != {"tensor_core": layers * TRAIN_STEPS}:
        raise AssertionError(f"phase p: backward launches by design "
                             f"{designs}, want {layers} tensor_core a step")
    want_lr = [schedule_lr(i + 1, TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
               for i in range(TRAIN_STEPS)]
    median = statistics.median(step_ms)
    READINGS["p"] = StepReading(cfg, "train", TRAIN_BATCH, TRAIN_SEQ, median,
                                f"p_train_qwen2_5_3b step_ms_median, "
                                f"{TRAIN_STEPS} steps")
    log({"phase": "p_train_qwen2_5_3b", "steps": TRAIN_STEPS,
         "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
         "step_ms_median": median, "step_ms": step_ms,
         "tokens_per_s": n_tok / (median / 1e3), "losses": losses,
         "lr": lrs, "lr_want": want_lr, "grad_norms": norms,
         "max_memory_allocated": peak,
         "max_memory_allocated_gb": peak / 1e9,
         "flash_launches_per_step": launches["flash_attention"] / TRAIN_STEPS,
         "flash_bwd_launches_per_step":
             launches["flash_attention_bwd"] / TRAIN_STEPS,
         "flash_bwd_launches_by_design_per_step":
             {k: n / TRAIN_STEPS for k, n in designs.items()},
         "adamw_launches_per_step": {k: launches[k] / TRAIN_STEPS
                                     for k in ADAMW_KERNELS}})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase p: losses {losses}: not all finite, or "
                             "the last not below the first")
    if any(abs(a - w) > 1e-6 * w for a, w in zip(lrs, want_lr)):
        raise AssertionError(f"phase p: lr {lrs} off the schedule {want_lr}")

    # One more step, profiled: the gradients, then AdamW.
    held = {}
    rows_g = device_profile(torch, lambda: held.update(g=grads_and_metrics(
        state.params, batch, cfg, 1)[0]), "p_train_grads")
    rows_a = device_profile(torch, lambda: optim.apply(
        ocfg, state.params, held["g"], state.opt), "p_train_adamw")
    if rows_g and rows_a:
        by_kind = {}
        for us, name, n in rows_g:
            kind = kernel_kind(name)
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        adamw_ms = sum(us for us, _, _ in rows_a) / 1e3
        device_ms = sum(by_kind.values()) + adamw_ms
        log({"profile": "p_train_step", "device_ms": device_ms,
             "device_busy_share_of_step": device_ms / median,
             "step_ms_median": median,
             "device_ms_by_kind": dict(by_kind, adamw_update=adamw_ms),
             "adamw_kernels": sum(n for _, _, n in rows_a),
             "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": n}
                     for us, k, n in rows_g[:14]]})
    del state, held, batch
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("flash_attention", "flash_attention_bwd")
            + ADAMW_KERNELS}


def trainer_path(torch, np, dev, seed: int) -> dict:
    """(p) The ``Trainer`` on the card: qwen2.5-3b's published widths cut
    to ``TRAINER_LAYERS`` layer, ``TRAINER_SPLIT`` steps with a checkpoint
    every ``TRAINER_EVERY`` (``keep`` 1), then resumed to
    ``TRAINER_STEPS``; the losses against an uninterrupted run's. The
    checkpoints go to a directory under ``build/`` that is removed."""
    import shutil
    import signal
    import tempfile

    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainConfig, TrainerConfig

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAINER_LAYERS)
    tcfg = TrainConfig(optimizer=optim.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAINER_STEPS))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="p_trainer_", dir=ROOT / "build"))
    sigterm = signal.getsignal(signal.SIGTERM)

    def run(name, total, every):
        t0 = time.perf_counter()
        out = Trainer(cfg, tcfg, TrainerConfig(
            total_steps=total, checkpoint_every=every,
            checkpoint_dir=str(root / name), keep_checkpoints=1, seed=seed,
            log_every=1000), dcfg, device=dev).train()
        torch.cuda.empty_cache()
        return out, time.perf_counter() - t0

    try:
        whole, s_whole = run("whole", TRAINER_STEPS, 1000)
        first, s_first = run("split", TRAINER_SPLIT, TRAINER_EVERY)
        kept = Checkpointer(str(root / "split"), keep=1).committed_steps()
        ckpt_bytes = sum(f.stat().st_size for f in
                         (root / "split" / f"step_{kept[-1]:09d}").iterdir())
        second, s_second = run("split", TRAINER_STEPS, TRAINER_EVERY)
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(root, ignore_errors=True)
    resumed = first["losses"] + second["losses"]
    want = whole["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, want))
    out = {"check": "p_trainer_resume", "layers": TRAINER_LAYERS,
           "losses_resumed": resumed, "losses_uninterrupted": want,
           "max_rel_diff": rel, "rtol": TRAINER_RTOL,
           "bit_equal": resumed == want, "kept_after_first_run": kept,
           "checkpoint_bytes": ckpt_bytes,
           "final_steps": [first["final_step"], second["final_step"]],
           "seconds": {"uninterrupted": s_whole, "first": s_first,
                       "resumed": s_second}}
    log(out)
    if len(resumed) != TRAINER_STEPS or rel > TRAINER_RTOL \
            or kept != [TRAINER_SPLIT] \
            or second["final_step"] != TRAINER_STEPS:
        raise AssertionError("phase p: the resumed trainer differs from the "
                             "uninterrupted one")
    return out


# ---------------------------------------------------------------------------
# Phase (q): every family trains on the card
# ---------------------------------------------------------------------------

#: The MoE backward kernels at each MoE arch's training shapes (a plan for
#: one DataIterator batch of Q_BATCH x Q_SEQ tokens); dbrx-132b's is timed.
MOE_BWD_ARCHS = ("dbrx-132b", "deepseek-v2-236b", "jamba-v0.1-52b")
#: Small cases: dtype, tokens, k, slot rows, d (16-byte chunks, k of 1, k
#: over the kernel's 8 copies a pass, widths not a multiple of 8).
MOE_BWD_SMALL = (("float32", 512, 4, 4096, 1024),
                 ("bfloat16", 512, 1, 1024, 1024),
                 ("bfloat16", 300, 6, 2048, 100),
                 ("float32", 256, 10, 4096, 37),
                 ("bfloat16", 256, 2, 1024, 7))
#: d_inv_weight against its plain version (a sum in another order): share
#: of the largest plain entry. d_tokens and d_expert_out are bit-identical.
MOE_BWD_TOL = 1e-5
Q_BATCH, Q_SEQ, Q_STEPS = 4, 512, 4


@dataclasses.dataclass(frozen=True)
class TrainFamily:
    arch: str
    layers: int | None       # depth cut to this many layers; None: published
    param_dtype: str         # bfloat16 (12 bytes a parameter with AdamW)
    steps: int               # train steps after the gradient check
    frames: int = 0          # encoder stub frames (the encoder-decoder)
    host_grads: bool = False  # the kernels' gradients wait on the host
    grads_compute: str | None = None  # the gradient check's compute dtype
    batch: int = Q_BATCH     # rows of the DataIterator batch
    seq: int = Q_SEQ         # tokens a row
    softcap: float | None = None  # a logit softcap the config lacks
    reduced: bool = False    # the reduced config, not the published one


#: The cuts fit one 80 GB card: dbrx-132b 1 of 40 layers (4.49 B
#: parameters, 54 GB with AdamW's state at bf16, and its update's fp32
#: temporaries on a 1.06 B-parameter expert leaf); deepseek-v2-236b its
#: dense layer 0 and one MoE layer (5.4 B, two gradient trees); jamba one
#: period of 8 (13.3 B: one tree of gradients on the card, the other on the
#: host); phi-3-vision-4.2b 16 of 32 layers at fp32 (about 35 GB).
#: seamless-m4t-medium's gradient check runs in fp32 compute (its train
#: steps in bf16): over the stub frames its encoder's memory rows share
#: 99.97 % of their norm, so the cross-attention's V rows differ by less
#: than a bf16 ulp of their common part, and the query-side gradients
#: (cross wq, wk, norm_c, about 1e-7 of the global norm) are set by where
#: the encoder rounded: two bf16 runs that differ in any bit there agree
#: on them at cosine 0.97, the plain ops' own bf16 run against fp32
#: included. gemma3-12b trains one period (5 windowed layers and 1 global,
#: 2.35 B parameters, 28 GB with AdamW) on 2 x 2,048 tokens, so that the
#: window of 1,024 bites in the backward; qwen3-14b and starcoder2-15b 2 of
#: their 40 layers each.
TRAIN_FAMILIES = (
    TrainFamily("dbrx-132b", 1, "bfloat16", Q_STEPS),
    TrainFamily("deepseek-v2-236b", 2, "bfloat16", 0),
    TrainFamily("jamba-v0.1-52b", 8, "bfloat16", 0, host_grads=True),
    TrainFamily("mamba2-780m", None, "float32", Q_STEPS),
    TrainFamily("seamless-m4t-medium", None, "float32", Q_STEPS, frames=512,
                grads_compute="float32"),
    TrainFamily("phi-3-vision-4.2b", 16, "float32", Q_STEPS),
    TrainFamily("gemma3-12b", 6, "bfloat16", Q_STEPS, batch=2, seq=2048),
    TrainFamily("qwen3-14b", 2, "bfloat16", Q_STEPS),
    TrainFamily("starcoder2-15b", 2, "bfloat16", Q_STEPS),
)
MOE_TRAIN_KERNELS = ("moe_gather", "moe_combine", "moe_gather_bwd",
                     "moe_combine_bwd")


def arch_plan(torch, dev, g, arch: str):
    """A dispatch plan at ``arch``'s training shape: Q_BATCH x Q_SEQ tokens
    routed by a skewed random router (dropped copies and empty slots)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity, moe_dispatch_plan
    m = get_config(arch).moe
    t = Q_BATCH * Q_SEQ
    skew = torch.linspace(-1.5, 1.5, m.num_experts, device=dev)
    probs = torch.softmax(torch.randn((t, m.num_experts), device=dev,
                                      generator=g) + skew, dim=-1)
    return moe_dispatch_plan(probs, m, capacity(t, m))


def dual_plan(torch, dev, g, t: int, k: int, rows: int):
    """(token_idx, inv_slot, inv_weight) of a random plan with the dispatch
    plan's duality: each kept copy has a slot of its own, token_idx names
    the slot's token, the other slots are empty; 30 % of the copies and
    every copy of the first 16 tokens dropped."""
    slot = torch.randperm(rows, device=dev, generator=g)[:t * k].view(
        t, k).int()
    slot[torch.rand((t, k), device=dev, generator=g) < 0.3] = -1
    slot[:16] = -1
    kept = slot >= 0
    token_idx = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    owner = torch.arange(t, dtype=torch.int32, device=dev)[:, None].expand(
        t, k)
    token_idx[slot[kept].long()] = owner[kept]
    w = torch.where(kept, torch.rand((t, k), device=dev, generator=g), 0.0)
    return token_idx, slot, w


def check_moe_backward(torch, np, dev, rng) -> dict:
    """Both MoE backward kernels against their plain versions (d_tokens
    and d_expert_out bit for bit, d_inv_weight within MOE_BWD_TOL; two
    launches bit-identical), at the MoE archs' training shapes and small
    cases; then their times at dbrx-132b's shape beside their bounds, the
    plain versions and the library yardsticks."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_dispatch import (
        moe_combine_backward, moe_combine_backward_plain, moe_combine_plain,
        moe_gather_backward, moe_gather_backward_plain)

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def rows(shape, dtype):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def hold(case, token_idx, slot, w, d, dtype):
        n, (t, k) = token_idx.shape[0], slot.shape
        d_slots, eo, dy = rows((n, d), dtype), rows((n, d), dtype), \
            rows((t, d), dtype)
        want_t = moe_gather_backward_plain(slot, d_slots)
        got_t = moe_gather_backward(slot, d_slots)
        again_t = moe_gather_backward(slot, d_slots)
        want_eo, want_w = moe_combine_backward_plain(slot, w, eo, dy)
        got_eo, got_w = moe_combine_backward(slot, w, eo, dy,
                                             token_idx=token_idx)
        again_eo, again_w = moe_combine_backward(slot, w, eo, dy,
                                                 token_idx=token_idx)
        torch.cuda.synchronize()
        rel = max_err(torch, got_w, want_w) / max(
            float(want_w.abs().max()), 1e-30)
        out = {"check": "moe_backward", "case": case, "dtype": str(dtype),
               "tokens": t, "k": k, "slots": n, "d": d,
               "kept": int((slot >= 0).sum()),
               "empty_slots": int((token_idx < 0).sum()),
               "d_tokens_equal": torch.equal(got_t, want_t),
               "d_expert_out_equal": torch.equal(got_eo, want_eo),
               "d_inv_weight_rel_err": rel, "tolerance": MOE_BWD_TOL,
               "bit_identical_across_launches": all(
                   torch.equal(a, b) for a, b in ((got_t, again_t),
                                                  (got_eo, again_eo),
                                                  (got_w, again_w)))}
        log(out)
        if not (out["d_tokens_equal"] and out["d_expert_out_equal"]
                and out["bit_identical_across_launches"]) \
                or rel > MOE_BWD_TOL:
            raise AssertionError(f"MoE backward kernels disagree: {out}")
        return rel

    worst = 0.0
    for arch in MOE_BWD_ARCHS:
        plan = arch_plan(torch, dev, g, arch)
        worst = max(worst, hold(arch, plan.token_idx, plan.inv_slot,
                                plan.inv_weight, get_config(arch).d_model,
                                torch.bfloat16))
        del plan
    for dtype, t, k, n, d in MOE_BWD_SMALL:
        worst = max(worst, hold("small", *dual_plan(torch, dev, g, t, k, n),
                                d, getattr(torch, dtype)))
    torch.cuda.empty_cache()

    # Times at dbrx-132b's training shape, bf16.
    plan = arch_plan(torch, dev, g, "dbrx-132b")
    token_idx, slot, w = plan.token_idx, plan.inv_slot, plan.inv_weight
    d, dtype = get_config("dbrx-132b").d_model, torch.bfloat16
    (t, k), n = slot.shape, token_idx.shape[0]
    el = 2
    kept = int((slot >= 0).sum())
    d_slots, eo, dy = rows((n, d), dtype), rows((n, d), dtype), \
        rows((t, d), dtype)
    stream = torch.cuda.current_stream().cuda_stream
    out_t = torch.empty((t, d), dtype=dtype, device=dev)
    d_eo = torch.empty_like(eo)
    d_w = torch.empty((t, k), dtype=torch.float32, device=dev)
    out = {}
    # The gather's backward reads each kept copy's slot row once and the
    # plan's inverse stream, and writes every token row once.
    g_bytes = kept * d * el + 4 * t * k + t * d * el
    b_ms, b_by = bound_ms(g_bytes, kept * d)
    safe = torch.where(token_idx >= 0, token_idx, t).long()
    out["moe_gather_bwd"] = {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: moe_gather_backward(slot, d_slots)),
        "kernel_ms": time_ms(torch, lambda: build.launch(
            "moe_gather_bwd", slot.data_ptr(), d_slots.data_ptr(),
            out_t.data_ptr(), t, d, k, 1, stream)),
        "plain_ms": time_ms(torch, lambda: moe_gather_backward_plain(
            slot, d_slots)),
        "library_ms": time_ms(torch, lambda: torch.zeros(
            (t + 1, d), dtype=dtype, device=dev).index_add_(0, safe,
                                                            d_slots)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": g_bytes}
    log({"time": "moe_gather_bwd", "tokens": t, "k": k, "slots": n,
         "kept": kept, "d": d, **out["moe_gather_bwd"],
         "library": "index_add_ of the slot rows by token_idx onto zeros "
                    "(empty slots to an overflow row)",
         "share_of_bound": b_ms / out["moe_gather_bwd"]["ms"],
         "kernel_share_of_bound": b_ms / out["moe_gather_bwd"]["kernel_ms"]})
    # The combine's backward reads dy, each kept copy's expert row, the
    # plan's streams, and writes every slot row and d_inv_weight once.
    c_bytes = t * d * el + kept * d * el + 8 * t * k + 4 * n \
        + n * d * el + 4 * t * k
    b_ms, b_by = bound_ms(c_bytes, 3 * kept * d)
    eo_r, w_r = eo.clone().requires_grad_(), w.clone().requires_grad_()
    y_lib = moe_combine_plain(slot, w_r, eo_r)
    w_err = max_err(torch, moe_combine_backward(
        slot, w, eo, dy, token_idx=token_idx)[1],
        moe_combine_backward_plain(slot, w, eo, dy)[1])
    out["moe_combine_bwd"] = {
        "max_abs_err": w_err,
        "ms": time_ms(torch, lambda: moe_combine_backward(
            slot, w, eo, dy, token_idx=token_idx)),
        "kernel_ms": time_ms(torch, lambda: build.launch(
            "moe_combine_bwd", slot.data_ptr(), w.data_ptr(), eo.data_ptr(),
            dy.data_ptr(), token_idx.data_ptr(), d_eo.data_ptr(),
            d_w.data_ptr(), t, n, d, k, 1, stream)),
        "plain_ms": time_ms(torch, lambda: moe_combine_backward_plain(
            slot, w, eo, dy)),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            y_lib, (eo_r, w_r), dy, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": c_bytes,
        "operations": 3 * kept * d}
    log({"time": "moe_combine_bwd", "tokens": t, "k": k, "slots": n,
         "kept": kept, "d": d, **out["moe_combine_bwd"],
         "library": "autograd.grad of the plain combine (index, multiply, "
                    "sum), w.r.t. expert_out and inv_weight",
         "share_of_bound": b_ms / out["moe_combine_bwd"]["ms"],
         "kernel_share_of_bound": b_ms / out["moe_combine_bwd"]["kernel_ms"],
         "worst_d_inv_weight_rel_err": worst})
    del plan, d_slots, eo, dy, out_t, d_eo, d_w, eo_r, w_r, y_lib
    torch.cuda.empty_cache()
    return out


def train_launches(cfg) -> dict:
    """The launches of one ``grads_and_metrics`` under remat: a period's
    kernels run twice forward (the forward and the recompute) and once
    backward, a prefix layer's once forward: flash per attention layer
    (and per encoder layer and cross-attention), the gather and the
    combine per MoE layer."""
    from repro_torch.models.transformer import n_periods
    runs = 1 if cfg.remat_policy == "none" else 2
    attn = ("attn", "local")
    prefix = cfg.first_k_dense if cfg.block_pattern[0][0] in attn else 0
    per_period = sum(m in attn for m, _ in cfg.block_pattern)
    flash = per_period * n_periods(cfg) * (2 if cfg.is_encdec else 1) \
        + cfg.encoder_layers
    moe = sum(f == "moe" for _, f in cfg.block_pattern) * n_periods(cfg)
    return {"flash_attention": prefix + runs * flash,
            "flash_attention_bwd": prefix + flash,
            "moe_gather": runs * moe, "moe_combine": runs * moe,
            "moe_gather_bwd": moe, "moe_combine_bwd": moe}


def recompute_rebuilt(torch, cfg, plans: list) -> int:
    """The recompute under remat rebuilt every forward dispatch plan: the
    plans come forward first, then recomputed, periods in reverse order and
    a period's layers in order. Returns the MoE layers."""
    n = len(plans) // 2
    per = sum(f == "moe" for _, f in cfg.block_pattern)
    if len(plans) != 2 * n or (n and not per):
        raise AssertionError(f"{len(plans)} dispatch plans under remat")
    if not n:
        return 0
    forward = [plans[i:i + per] for i in range(0, n, per)]
    again = [plans[n + i:n + i + per] for i in range(0, n, per)]
    for first, second in zip(forward, reversed(again)):
        for a, b in zip(first, second):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError("the recompute built another dispatch "
                                     "plan than the forward")
    return n


def train_batch(torch, np, dev, rng, cfg, spec, seed: int) -> dict:
    """One DataIterator batch of spec.batch x spec.seq tokens, and the
    stub frontend embeddings (frames, patches) from ``rng``."""
    from repro_torch.data import DataConfig, DataIterator
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=spec.seq,
                                   global_batch=spec.batch, seed=seed))
    try:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()
                 if k in ("tokens", "labels", "loss_mask")}
    finally:
        data.close()
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    if spec.frames:
        batch["frames"] = torch.randn((spec.batch, spec.frames, cfg.d_model),
                                      device=dev, generator=g) * STUB_SCALE
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.randn(
            (spec.batch, cfg.prefix_len, cfg.d_model), device=dev,
            generator=g) * STUB_SCALE
    return batch


def train_family_run(torch, np, dev, rng, seed: int,
                     spec: TrainFamily) -> dict:
    """One family at its published widths (cut as ``spec`` says): one
    ``grads_and_metrics`` through the kernels (launches counted, the
    recompute's plans held to the forward's) against the same on the plain
    ops with those plans replayed in order; then ``spec.steps`` train steps
    on the same batch. Returns the launches."""
    from collections import Counter

    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (LAUNCHES_BY_DESIGN,
                                                     bwd_design)
    from repro_torch.models import init_params
    from repro_torch.train import (TrainConfig, grads_and_metrics,
                                   init_state, make_train_step)
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(get_config(spec.arch, reduced=spec.reduced),
                              param_dtype=spec.param_dtype)
    if spec.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=spec.layers)
    if spec.softcap is not None:
        cfg = dataclasses.replace(cfg, attn_logit_softcap=spec.softcap)
    label = spec.arch.replace("-", "_").replace(".", "_") \
        + ("_reduced" if spec.reduced else "") \
        + ("_softcap" if spec.softcap is not None else "")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    torch.cuda.synchronize()
    log({"init": spec.arch, "phase": "q", "layers": cfg.num_layers,
         "published_layers": get_config(spec.arch).num_layers,
         "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
         "param_dtype": cfg.param_dtype, "compute": str(cfg.cdtype),
         "remat_policy": cfg.remat_policy,
         "params": sum(x.numel() for x in _leaves(params)),
         "param_bytes": sum(x.numel() * x.element_size()
                            for x in _leaves(params)),
         "seconds": time.perf_counter() - t0})
    batch = train_batch(torch, np, dev, rng, cfg, spec, seed)
    want = train_launches(cfg)
    gcfg = cfg if spec.grads_compute is None else dataclasses.replace(
        cfg, compute_dtype=spec.grads_compute)

    # The gradients through the kernels, every dispatch plan and expert
    # choice recorded.
    plans, routes = [], []
    by_design = Counter(LAUNCHES_BY_DESIGN)
    build.reset_launches()                    # the family's path starts here
    t0 = time.perf_counter()
    with recording_plans(plans), recording_routes(routes):
        grads, m = grads_and_metrics(params, batch, gcfg, 1)
    torch.cuda.synchronize()
    grads_ms = (time.perf_counter() - t0) * 1e3
    launches = build.launch_counts()          # ... and pauses here
    expect_launches(f"q {spec.arch} grads", launches, want)
    # bf16 compute takes the tensor-core flash backward at every head dim
    # (MLA's 192/128 and 256 included), fp32 the CUDA-core one.
    designs = dict(Counter(LAUNCHES_BY_DESIGN) - by_design)
    bwd = want["flash_attention_bwd"]
    want_designs = {bwd_design(*flash_dims(cfg), gcfg.cdtype): bwd} \
        if bwd else {}
    if designs != want_designs:
        raise AssertionError(f"phase q {spec.arch}: flash backward launches "
                             f"by design {designs}, want {want_designs}")
    n_moe = recompute_rebuilt(torch, cfg, plans)
    grads_peak = torch.cuda.max_memory_allocated()
    loss, gnorm = float(m["loss"]), float(optim.global_norm(grads))
    ours = flatten(grads)
    del grads, m
    if spec.host_grads:                       # two trees do not fit
        ours = {k: v.to("cpu") for k, v in ours.items()}
        torch.cuda.empty_cache()

    # The same on the plain ops, the expert choices replayed in the order
    # made (forward, then the recompute's), so that both runs route alike.
    del plans
    flipped = []
    before = build.launch_counts()
    with plain_kernels(torch, flipped=flipped, routes=iter(routes)):
        grads_p, m_p = grads_and_metrics(params, batch, gcfg, 1)
    torch.cuda.synchronize()
    if build.launch_counts() != before:
        raise AssertionError(f"phase q {spec.arch}: the plain gradients "
                             "launched a kernel")
    loss_p, gnorm_p = float(m_p["loss"]), float(optim.global_norm(grads_p))
    plain = flatten(grads_p)
    del grads_p, m_p, routes
    cos, both_zero = [], []
    for k, b in plain.items():
        a = ours.pop(k).to(dev)
        if not (a.any() or b.any()):          # a leaf the batch never reached
            both_zero.append(k)
            continue
        cos.append((cosine(torch, a, b), k))
        del a
    cos.sort()
    del ours, plain
    torch.cuda.empty_cache()
    ok = abs(loss - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p) \
        and abs(gnorm - gnorm_p) <= TRAIN_NORM_RTOL * gnorm_p \
        and cos[0][0] >= TRAIN_MIN_COS
    log({"check": f"q_{label}_grads_vs_plain", "loss": loss,
         "loss_plain": loss_p, "loss_rel_err": abs(loss - loss_p) / abs(loss_p),
         "grad_norm": gnorm, "grad_norm_plain": gnorm_p,
         "grad_norm_rel_err": abs(gnorm - gnorm_p) / gnorm_p,
         "leaves": len(cos) + len(both_zero), "leaves_zero_in_both":
             both_zero, "worst_leaf": cos[0][1], "worst_cosine": cos[0][0],
         "next_worst": [{"leaf": k, "cosine": c} for c, k in cos[1:4]],
         "compute": str(gcfg.cdtype),
         "moe_layers": n_moe, "recompute_rebuilt_plans": True,
         "copies_routed_otherwise_in_plain_run": flipped,
         "plain_grads_on_host": spec.host_grads,
         "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                       "grad_norm_rtol": TRAIN_NORM_RTOL,
                       "min_cosine": TRAIN_MIN_COS},
         "grads_ms_first_call": grads_ms,
         "flash_bwd_launches_by_design": designs, "launches": launches,
         "max_memory_allocated_grads": grads_peak})
    if not ok:
        raise AssertionError(f"phase q {spec.arch}: the gradients through the "
                             "kernels differ from the plain ops' beyond "
                             "tolerance")
    out = {"launches": launches, "grads_peak": grads_peak,
           "worst_cosine": cos[0][0], "worst_leaf": cos[0][1]}
    seq = spec.seq + cfg.prefix_len
    if not spec.steps:            # no train step fits: the gradients' call
        READINGS[f"q_{label}"] = StepReading(
            gcfg, "grads", spec.batch, seq, grads_ms,
            f"q_{label}_grads_vs_plain grads_ms_first_call, 1 call")

    if spec.steps:
        tcfg = TrainConfig(optimizer=optim.AdamWConfig(
            lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=spec.steps))
        state = init_state(params, tcfg)
        del params
        step = make_train_step(cfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()                # ... resumes here
        losses, step_ms = [], []
        for _ in range(spec.steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))   # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        steps = build.launch_counts()         # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        expect_launches(f"q {spec.arch} steps", steps,
                        {**{k: n * spec.steps for k, n in want.items()},
                         **adamw_launches(state.params, spec.steps)})
        launches = {k: launches[k] + steps[k] for k in launches}
        median = statistics.median(step_ms)
        READINGS[f"q_{label}"] = StepReading(
            cfg, "train", spec.batch, seq, median,
            f"q_train_{label} step_ms_median, {spec.steps} steps")
        log({"phase": f"q_train_{label}", "steps": spec.steps,
             "batch": spec.batch, "seq_len": spec.seq,
             "step_ms_median": median, "step_ms": step_ms,
             "tokens_per_s": spec.batch * spec.seq / (median / 1e3),
             "losses": losses, "max_memory_allocated": peak,
             "max_memory_allocated_gb": peak / 1e9,
             "launches_per_step": {k: n / spec.steps
                                   for k, n in steps.items() if n}})
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"phase q {spec.arch}: losses {losses}: not "
                                 "all finite, or the last not below the "
                                 "first")
        out.update(launches=launches, step_ms_median=median, losses=losses,
                   peak=peak)
        # One more step, profiled: the gradients, then AdamW.
        held = {}
        rows_g = device_profile(torch, lambda: held.update(
            g=grads_and_metrics(state.params, batch, cfg, 1)[0]),
            f"q_{label}_grads")
        rows_a = device_profile(torch, lambda: optim.apply(
            tcfg.optimizer, state.params, held["g"], state.opt),
            f"q_{label}_adamw")
        if rows_g and rows_a:
            by_kind = {}
            for us, name, _ in rows_g:
                kind = kernel_kind(name)
                by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
            adamw_ms = sum(us for us, _, _ in rows_a) / 1e3
            device_ms = sum(by_kind.values()) + adamw_ms
            log({"profile": f"q_{label}_train_step", "device_ms": device_ms,
                 "device_busy_share_of_step": device_ms / median,
                 "step_ms_median": median,
                 "device_ms_by_kind": dict(by_kind, adamw_update=adamw_ms),
                 "kernels": sum(n for _, _, n in rows_g + rows_a),
                 "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": n}
                         for us, k, n in rows_g[:8]]})
        del state, held
    else:
        del params
    del batch
    torch.cuda.empty_cache()
    return out


def train_family_path(torch, np, dev, rng, seed: int) -> dict:
    """(q) The nine families, each freed before the next; both MoE backward
    kernels must have run. Returns the launches summed over them."""
    from collections import Counter
    total = Counter()
    for spec in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        out = train_family_run(torch, np, dev, rng, seed, spec)
        total.update(out["launches"])
        log({"phase": f"q_{spec.arch}", "seconds": time.perf_counter() - t0,
             "launches": {k: n for k, n in out["launches"].items() if n}})
    for name in MOE_TRAIN_KERNELS + ("flash_attention", "flash_attention_bwd"):
        if not total[name]:
            raise AssertionError(f"phase q: {name} never launched")
    return dict(total)


# ---------------------------------------------------------------------------
# Phase (r): each timed training and prefill step against its count
# ---------------------------------------------------------------------------

#: Phase (r)'s production cell of the dry-run CLI.
R_CELL = ("qwen3-14b", "train_4k", "single")


def grads_count(cfg, shape) -> dict:
    """The dry run's method for the gradients alone (``grads_and_metrics``,
    no AdamW), global: P=1 and P=2 periods counted with the core skipped,
    extrapolated, and the analytic core added."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.inputs import train_input_specs
    from repro_torch.models import param_shapes
    from repro_torch.roofline import analysis as ra
    from repro_torch.train import grads_and_metrics

    batch = train_input_specs(cfg, shape)

    def counted(n):
        c = dryrun._with_periods(cfg, n)
        params = param_shapes(c)
        return dryrun.count(lambda: grads_and_metrics(params, batch, c,
                                                      1))[0]
    m1, m2 = counted(1), counted(2)
    periods = (cfg.num_layers - cfg.first_k_dense) // len(cfg.block_pattern)
    core_f, core_b = ra.core_totals(cfg, shape)
    return {"flops": ra.extrapolate(m1["flops"], m2["flops"], periods)
            + core_f,
            "bytes": ra.extrapolate(m1["bytes"], m2["bytes"], periods)
            + core_b}


def roofline_path(torch, dev, smi: str) -> dict:
    """(r) Each step phases (j), (l), (p) and (q) timed, and the prefills
    of (o)'s dense family, read against the dry run's count of the same
    step (same config, depth and batch) on a
    1x1 mesh of this card and the H100's peaks: model FLOPs, the counted
    FLOPs and bytes, the roofline's terms, step time and bottleneck, the
    measured step, the model-FLOP share of the card's peak over it (mfu)
    and the roofline step's share of it. The count runs on the meta device
    and must allocate nothing on the card. A train step's line also gives
    the bytes its AdamW update adds (the step's count less the gradients').
    Then one production cell of the dry-run CLI into a temporary
    directory. Returns the lines."""
    import os
    import tempfile

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline import analysis as ra

    def key(arch):
        return arch.replace("-", "_").replace(".", "_")
    want = {"p", "j", "l"} | {f"q_{key(f.arch)}" for f in TRAIN_FAMILIES} \
        | {f"o_{key(f.arch)}" for f in FAMILIES if f.read}
    if set(READINGS) != want:
        raise AssertionError(f"phase r: readings {sorted(READINGS)}, want "
                             f"{sorted(want)}")
    mesh = make_debug_mesh(1, 1, devices=dev)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    lines = {}
    for key, r in READINGS.items():
        kind = "train" if r.kind == "grads" else r.kind
        shape = ShapeConfig(f"{key}_{r.batch}x{r.seq}", r.seq, r.batch, kind)
        t0 = time.perf_counter()
        if r.kind == "grads":
            c = grads_count(r.cfg, shape)
            roof = ra.Roofline(
                arch=r.cfg.name, shape=shape.name, mesh="1x1", chips=1,
                hlo_flops_per_chip=c["flops"], hlo_bytes_per_chip=c["bytes"],
                wire_bytes_per_chip=None, collectives=None,
                model_flops=ra.model_flops(r.cfg, shape),
                bytes_per_chip_hbm=None)
        else:
            cell = dryrun.count_cell(r.cfg, shape, mesh, "1x1")
            roof = ra.Roofline(**{k: cell["roofline"][k] for k in (
                "arch", "shape", "mesh", "chips", "hlo_flops_per_chip",
                "hlo_bytes_per_chip", "wire_bytes_per_chip", "collectives",
                "model_flops", "bytes_per_chip_hbm")})
        # A train step's bytes without AdamW's: the optimizer's share.
        grads_bytes = grads_count(r.cfg, shape)["bytes"] \
            if r.kind == "train" else None
        count_s = time.perf_counter() - t0
        if not (roof.hlo_flops_per_chip > 0 and roof.hlo_bytes_per_chip > 0
                and roof.model_flops > 0 and r.ms > 0):
            raise AssertionError(f"phase r {key}: a count or reading of 0: "
                                 f"{roof.to_dict()}, {r.ms} ms")
        measured_s = r.ms / 1e3
        line = {"phase": f"r_{key}", "arch": r.cfg.name,
                "layers": r.cfg.num_layers, "step": r.kind,
                "batch": r.batch, "seq_len": r.seq,
                "model_flops": roof.model_flops,
                "counted_flops": roof.hlo_flops_per_chip,
                "counted_bytes": roof.hlo_bytes_per_chip,
                "counted_bytes_adamw": None if grads_bytes is None
                else roof.hlo_bytes_per_chip - grads_bytes,
                "useful_flops_ratio": roof.useful_flops_ratio,
                "compute_s": roof.compute_s, "memory_s": roof.memory_s,
                "collective_s": roof.collective_s,
                "step_time_s": roof.step_time_s,
                "bottleneck": roof.bottleneck,
                "measured_ms": r.ms, "measured": r.reading,
                "mfu": roof.model_flops / (ra.PEAK_FLOPS * measured_s),
                "roofline_share": roof.step_time_s / measured_s,
                "peak_flops": ra.PEAK_FLOPS, "hbm_bytes_per_s": ra.HBM_BW,
                "count_s": count_s, "card": smi}
        log(line)
        lines[key] = line
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != allocated:
        raise AssertionError(
            f"phase r: the counts allocated on the card: "
            f"{torch.cuda.memory_allocated() - allocated} bytes")

    # One production cell of the dry-run CLI.
    arch, shape_name, mesh_name = R_CELL
    old = os.environ.get("REPRO_DRYRUN_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_DRYRUN_DIR"] = tmp
        try:
            t0 = time.perf_counter()
            rc = dryrun.main(["--arch", arch, "--shape", shape_name,
                              "--mesh", mesh_name, "--force"])
            seconds = time.perf_counter() - t0
        finally:
            if old is None:
                del os.environ["REPRO_DRYRUN_DIR"]
            else:
                os.environ["REPRO_DRYRUN_DIR"] = old
        path = Path(tmp) / mesh_name / f"{arch}__{shape_name}.json"
        cell = json.loads(path.read_text())
    roof = cell.get("roofline", {})
    if rc != 0 or cell["status"] != "ok"             or any(k not in cell for k in dryrun.RESULT_KEYS)             or cell["chips"] != 256 or roof["wire_bytes_per_chip"] is not None             or roof["compute_s"] != roof["hlo_flops_per_chip"] / ra.PEAK_FLOPS:
        raise AssertionError(f"phase r: the dry-run cell {R_CELL}: rc {rc}, "
                             f"{json.dumps(cell)[:2000]}")
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != allocated:
        raise AssertionError("phase r: the dry-run cell allocated on the "
                             "card")
    log({"phase": "r_dryrun_cell", "arch": arch, "shape": shape_name,
         "mesh": mesh_name, "status": cell["status"], "chips": cell["chips"],
         "seconds": seconds, "memory": cell["memory"],
         "roofline": {k: roof[k] for k in (
             "model_flops", "hlo_flops_per_chip", "hlo_bytes_per_chip",
             "compute_s", "memory_s", "collective_s", "bottleneck",
             "useful_flops_ratio", "mfu")},
         "peak_flops": ra.PEAK_FLOPS, "card": smi})
    return lines


# ---------------------------------------------------------------------------
# Phase (s): the collective path, worlds of ranks sharing the card over gloo
# ---------------------------------------------------------------------------

#: A world's time limit: past it every rank is killed and the smoke fails.
S_TIMEOUT = 420
#: Every rank's device, and the module whose functions the ranks run.
S_DEVICE, S_RANKS_MODULE = "cuda:0", "chip_smoke"
S_ARCH, S_LAYERS = "qwen2.5-3b", 4          # (s2), (s4), (s5)
S_MOE_ARCH, S_MOE_LAYERS = "dbrx-132b", 1   # (s1), (s3)
#: (s7) deepseek-v2-236b cut to its dense first layer (MLA and the
#: 12,288-wide MLP, 0 periods); (s8) its MoE FFN with the shared expert.
S_MLA_ARCH, S_MLA_LAYERS = "deepseek-v2-236b", 1
#: (s9) seamless-m4t-medium uncut, over S_FRAMES stub frames, in fp32
#: compute: its cross-attention's query-side gradients are set by where
#: the encoder rounds, and two bf16 runs that round differently agree on
#: them at cosine 0.97 (TRAIN_FAMILIES), past the moments' bound.
S_ENCDEC_ARCH, S_FRAMES = "seamless-m4t-medium", 512
#: The world of 2 ranks runs (s1), (s3)-(s5) and (s7)-(s9): its limit.
S_PAIR_TIMEOUT = 900
S_BATCH, S_SEQ = 4, 512
S_STEPS, S_MOE_STEPS = 3, 2
#: (s2)'s last step, in the reference's microbatches (ROADMAP C1).
S_MICROBATCHES = 2
#: How the sharded step reduces a gradient its spec splits over the batch
#: axes: gloo runs reduce_scatter_tensor on CUDA tensors (fp32 and bf16,
#: torch 2.11 on the H100, tools/gloo_collectives_probe.py).
S_REDUCE_FORM = "reduce_scatter_tensor (gloo, on the card's tensors)"
S_LR, S_WARMUP = TRAIN_LR, TRAIN_WARMUP
#: (s1): the output of expert parallelism sums each rank's bf16 partial in
#: bf16 (gloo's all-reduce), where one process rounds its fp32 sum once:
#: four bf16 half-ulps of the largest output apart at most.
S_Y_TOL = 2.0 ** -6
#: (s2)-(s5) against one process, bf16 compute: the ranks' gradients are
#: bf16 partial sums over their rows added in fp32, so (p)'s bounds hold
#: each step's loss and global norm and the moments of every leaf
#: (cosine), except the key bias's: its true gradient is 0, so both runs
#: move it by rounding noise (tests/test_torch_train.py). Each parameter
#: within 2 lr a step (an AdamW step moves a parameter by about lr at
#: most, either way) and, in bf16, one half-ulp of its largest entry.
S_PARAM_STEP_LRS = 2.0
S_NOISE_LEAVES = ("bk",)


def s_cfgs(arch: str, layers, param_dtype=None, compute_dtype=None):
    """``arch`` at published widths, cut to ``layers`` (None: uncut)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return cfg


def s_rank_setup():
    """Every rank's start: the card, no TF32 (as the smoke's own process)."""
    import torch
    torch.cuda.set_device(S_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, torch.device(S_DEVICE)


def s_batch(torch, cfg, seed: int, dev) -> dict:
    """The global batch of S_BATCH x S_SEQ tokens of the data pipeline;
    every rank draws it and takes its rows (``local_batch``)."""
    from repro_torch.data import DataConfig, DataIterator
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=S_SEQ,
                                   global_batch=S_BATCH, seed=seed))
    try:
        return {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()
                if k in ("tokens", "labels", "loss_mask")}
    finally:
        data.close()


def s_tcfg(steps: int, grad_clip: float = 1.0, compress=None):
    from repro_torch import optim
    from repro_torch.train import TrainConfig
    return TrainConfig(optimizer=optim.AdamWConfig(
        lr=S_LR, warmup_steps=S_WARMUP, total_steps=steps + 1,
        grad_clip=grad_clip), compress_pod_axis=compress)


def s_traffic(mesh, before: dict, steps: int) -> dict:
    """Bytes a step, per kind, that the sharded step moved through
    ``mesh``'s collectives since ``before`` (``Mesh.traffic``): the
    parameters' gathers (received) and the gradients put into each form
    of reduction."""
    return {k: (v - before.get(k, 0)) / steps
            for k, v in mesh.traffic.items()}


def s_steps(torch, state, batch, cfg, tcfg, n: int, mesh=None):
    """``n`` train steps: the state, each step's metrics and host ms."""
    from repro_torch.distributed import shardlib
    from repro_torch.distributed.sharding import activation_rules
    from repro_torch.train import train_step
    metrics, ms = [], []
    ctx = shardlib.use_mesh(mesh, activation_rules(mesh)) if mesh \
        else contextlib.nullcontext()
    with ctx:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(state, batch, cfg, tcfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, ms


def s_host(state):
    """A state's leaves copied to the host, by path (its card memory can
    then go to a one-process reference)."""
    from repro_torch.tree import flatten
    return {k: v.detach().to("cpu", copy=True)
            for k, v in flatten(state).items()}


def s_hold_leaves(torch, blocks: dict, ref_state, specs: dict, mesh,
                  steps: int) -> dict:
    """This rank's blocks (host) against its blocks of the one-process
    state: the moments' cosine (the noise leaves apart), the parameters'
    largest difference against S_PARAM_STEP_LRS lr a step (and a bf16
    parameter's half-ulp)."""
    from repro_torch.distributed.sharding import take_block
    from repro_torch.tree import flatten
    ref = flatten(ref_state)
    worst_cos, worst_param, over = (2.0, ""), (0.0, ""), []
    for k, blk in blocks.items():
        want = take_block(ref[k], specs[k], mesh)
        got = blk.to(want.device)
        if tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"phase s: {k} block {tuple(got.shape)}, "
                                 f"expected {tuple(want.shape)}")
        noise = k.rsplit("/", 1)[-1] in S_NOISE_LEAVES
        if k.startswith(".opt/.m/") or k.startswith(".opt/.v/"):
            if not noise and got.numel() > 1:
                c = cosine(torch, got, want)
                worst_cos = min(worst_cos, (c, k))
                if c < TRAIN_MIN_COS:
                    over.append((k, c))
        elif k.startswith(".params/"):
            err = max_err(torch, got, want)
            bound = S_PARAM_STEP_LRS * S_LR * steps
            if want.dtype == torch.bfloat16:
                bound += 2.0 ** -8 * float(want.float().abs().max())
            worst_param = max(worst_param, (err / bound, k))
            if err > bound:
                over.append((k, err))
    return {"worst_moment_cosine": worst_cos[0],
            "worst_moment_leaf": worst_cos[1],
            "worst_param_share_of_bound": worst_param[0],
            "worst_param_leaf": worst_param[1], "over": over}


def s_each_rank(rank: int, world: int, fn):
    """``fn()`` on one rank at a time, in rank order (the others wait)."""
    import torch.distributed as dist
    out = None
    for r in range(world):
        dist.barrier()
        if r == rank:
            out = fn()
    dist.barrier()
    return out


def s_nccl_rank(rank, world):
    """(s) NCCL with two ranks on the one card: make_process_mesh must
    raise (NCCL refuses a duplicate GPU), not fall back to gloo."""
    s_rank_setup()
    from repro_torch.launch.mesh import make_process_mesh
    try:
        make_process_mesh(1, 2, backend="nccl", device=S_DEVICE)
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return {"refused": True, "error": f"{type(e).__name__}: {e}"}
    return {"refused": False}


def s2_rank(rank, world, *, seed, ckpt):
    """(s2) qwen2.5-3b cut to S_LAYERS on data 2 x model 2: S_STEPS sharded
    steps, a checkpoint (rank 0 writes), one more step, and one at
    S_MICROBATCHES; then each rank in turn runs the one-process steps on
    the whole batch and holds its blocks against them (and the last
    step's loss and norm against one process's grads_and_metrics)."""
    torch, dev = s_rank_setup()
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding import shard_shape, \
        train_state_specs
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import init_params
    from repro_torch.train import (init_state, local_batch, shard_state,
                                   state_block_specs, state_shapes)
    from repro_torch.tree import flatten

    cfg = s_cfgs(S_ARCH, S_LAYERS)
    tcfg = s_tcfg(S_STEPS)
    mesh = make_process_mesh(2, 2, backend="gloo", device=S_DEVICE)
    gen = torch.Generator(device=dev)
    state = shard_state(init_params(gen.manual_seed(seed), cfg, dev), cfg,
                        tcfg, mesh)
    torch.cuda.empty_cache()
    specs = flatten(state_block_specs(cfg, mesh, tcfg))
    whole = flatten(state_shapes(cfg, tcfg))
    dry = flatten(train_state_specs(cfg, mesh, state_shapes(cfg, tcfg)))
    shapes_ok = all(tuple(v.shape) == shard_shape(tuple(whole[k].shape),
                                                  dry[k], mesh)
                    for k, v in flatten(state).items())
    batch = s_batch(torch, cfg, seed, dev)
    rows = local_batch(batch, mesh)
    torch.cuda.reset_peak_memory_stats()
    before = dict(mesh.traffic)
    build.reset_launches()                  # the sharded steps start here
    state, metrics, ms = s_steps(torch, state, rows, cfg, tcfg, S_STEPS, mesh)
    launches = build.launch_counts()        # ... and end here
    peak = torch.cuda.max_memory_allocated()
    traffic = s_traffic(mesh, before, S_STEPS)
    blocks = s_host(state)
    t0 = time.perf_counter()
    Checkpointer(ckpt).save(S_STEPS, state, extra={"phase": "s2"},
                            mesh=mesh, specs=state_block_specs(cfg, mesh,
                                                               tcfg))
    save_s = time.perf_counter() - t0
    state, next_m, _ = s_steps(torch, state, rows, cfg, tcfg, 1, mesh)
    # One more step in the reference's microbatches (C1).
    mb_tcfg = dataclasses.replace(tcfg, microbatches=S_MICROBATCHES)
    state, mb_m, mb_ms = s_steps(torch, state, rows, cfg, mb_tcfg, 1, mesh)
    del state
    torch.cuda.empty_cache()

    def reference():
        from repro_torch.optim import global_norm
        from repro_torch.train import grads_and_metrics
        st = init_state(init_params(gen.manual_seed(seed), cfg, dev), tcfg)
        st, ref_m, ref_ms = s_steps(torch, st, batch, cfg, tcfg, S_STEPS)
        held = s_hold_leaves(torch, blocks, st, specs, mesh, S_STEPS)
        st, ref_next, _ = s_steps(torch, st, batch, cfg, tcfg, 1)
        grads, m = grads_and_metrics(st.params, batch, cfg, S_MICROBATCHES)
        ref_mb = {"loss": float(m["loss"]),
                  "grad_norm": float(global_norm(grads))}
        del st, grads
        torch.cuda.empty_cache()
        return ref_m, ref_ms, ref_next, held, ref_mb

    ref_m, ref_ms, ref_next, held, ref_mb = s_each_rank(rank, world,
                                                        reference)
    return {"coords": dict(mesh.coords), "metrics": metrics, "ms": ms,
            "ref_metrics": ref_m, "ref_ms": ref_ms, "next": next_m[0],
            "ref_next": ref_next[0], "held": held, "launches": launches,
            "peak_bytes": peak, "shapes_ok": shapes_ok, "save_s": save_s,
            "block_bytes": sum(v.numel() * v.element_size()
                               for v in blocks.values()),
            "traffic_per_step": traffic, "microbatched": mb_m[0],
            "microbatched_ms": mb_ms[0], "ref_microbatched": ref_mb}


def s_ep_ffn(torch, dev, seed: int, arch: str) -> dict:
    """(s1), (s8) ``arch``'s MoE FFN at published widths, bf16 weights, on
    model 2 of the rank's world: y, aux and the gradients of x, the
    router, the rank's experts and the rank's block of the shared expert
    (over its width, where the arch has one) against the one-process
    moe_ffn on the same card."""
    import torch.distributed as dist

    from repro_torch.distributed import shardlib
    from repro_torch.distributed.sharding import activation_rules
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.moe import init_moe, moe_ffn
    from repro_torch.tree import flatten, map_with_path, tree_map

    cfg = s_cfgs(arch, S_MOE_LAYERS, "bfloat16")
    mesh = make_process_mesh(1, 2, backend="gloo", device=S_DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_moe(gen, cfg, dev)
    x = (torch.randn((S_BATCH, S_SEQ, cfg.d_model), device=dev,
                     generator=gen) * 0.5).to(cfg.cdtype)
    w = torch.randn(x.shape, device=dev, generator=gen).to(cfg.cdtype)
    r = mesh.coords["model"]
    e_loc = cfg.moe.num_experts // 2

    def block(k, t):
        """The rank's part of leaf ``k``: its experts, its columns of the
        shared expert's w_gate and w_up and its rows of w_down."""
        name = k.rsplit("/", 1)[-1]
        if not k.startswith("shared/"):
            return t[r * e_loc:(r + 1) * e_loc] if name != "router" else t
        if name == "w_down":
            f = t.shape[0] // 2
            return t[r * f:(r + 1) * f]
        f = t.shape[1] // 2
        return t[:, r * f:(r + 1) * f]

    def run(p, ep: bool):
        leaves = tree_map(lambda v: v.detach().requires_grad_(), p)
        xin = x.detach().requires_grad_()
        ctx = shardlib.use_mesh(mesh, activation_rules(mesh)) if ep \
            else contextlib.nullcontext()
        with ctx:
            y, aux, metrics = moe_ffn(leaves, xin, cfg, cfg.act_fn)
            ((y.float() * w.float()).sum() + aux).backward()
        torch.cuda.synchronize()
        return {"y": y.detach(), "aux": aux.detach(),
                "dropped": metrics["moe_dropped"].detach(),
                "grads": {"x": xin.grad, **{k: v.grad for k, v in
                                            flatten(leaves).items()}}}

    # The rank's experts and shared block as views: its leaves are E_loc
    # experts and half the shared width.
    mine = map_with_path(block, params)
    build.reset_launches()                  # the EP call starts here
    ep = run(mine, True)
    launches = build.launch_counts()        # ... and ends here

    def timed(p, is_ep):
        return time_ms(torch, lambda: run(p, is_ep), reps=5, warm=1)
    ep_ms = timed(mine, True)
    dist.barrier()
    one = s_each_rank(mesh.rank, 2, lambda: run(params, False))
    one_ms = s_each_rank(mesh.rank, 2, lambda: timed(params, False))
    y_err = max_err(torch, ep["y"], one["y"])
    y_bound = S_Y_TOL * float(one["y"].float().abs().max())
    cos = {k: cosine(torch, g, one["grads"][k] if k == "x"
                     else block(k, one["grads"][k]))
           for k, g in ep["grads"].items()}
    out = {"y_err": y_err, "y_bound": y_bound,
           "aux_equal": bool(torch.equal(ep["aux"], one["aux"])),
           "dropped_equal": bool(torch.equal(ep["dropped"],
                                             one["dropped"])),
           "dropped": float(one["dropped"]), "grad_cosines": cos,
           "launches": launches, "ep_ms": ep_ms, "one_ms": one_ms}
    del ep, one, params, mine
    torch.cuda.empty_cache()
    return out


def s_model_steps(torch, dev, seed: int, cfg, steps: int,
                  frames: int = 0) -> dict:
    """(s3), (s7), (s9) ``cfg`` on data 1 x model 2: ``steps`` sharded
    steps (the batch with ``frames`` stub encoder frames where given);
    then each rank in turn (its state on the host) the one-process steps,
    held as (s2)."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import init_params
    from repro_torch.train import (init_state, local_batch, shard_state,
                                   state_block_specs)
    from repro_torch.tree import flatten

    tcfg = s_tcfg(steps)
    mesh = make_process_mesh(1, 2, backend="gloo", device=S_DEVICE)
    gen = torch.Generator(device=dev)
    torch.cuda.reset_peak_memory_stats()
    state = shard_state(init_params(gen.manual_seed(seed), cfg, dev), cfg,
                        tcfg, mesh)
    torch.cuda.empty_cache()
    specs = flatten(state_block_specs(cfg, mesh, tcfg))
    batch = s_batch(torch, cfg, seed, dev)
    if frames:
        batch["frames"] = torch.randn(
            (S_BATCH, frames, cfg.d_model), device=dev,
            generator=gen.manual_seed(seed + 1)) * STUB_SCALE
    rows = local_batch(batch, mesh)
    before = dict(mesh.traffic)
    build.reset_launches()                  # the sharded steps start here
    state, metrics, ms = s_steps(torch, state, rows, cfg, tcfg, steps, mesh)
    launches = build.launch_counts()        # ... and end here
    peak = torch.cuda.max_memory_allocated()
    traffic = s_traffic(mesh, before, steps)
    blocks = s_host(state)
    del state
    torch.cuda.empty_cache()

    def reference():
        torch.cuda.reset_peak_memory_stats()
        st = init_state(init_params(gen.manual_seed(seed), cfg, dev), tcfg)
        st, ref_m, ref_ms = s_steps(torch, st, batch, cfg, tcfg, steps)
        held = s_hold_leaves(torch, blocks, st, specs, mesh, steps)
        del st
        ref_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        return ref_m, ref_ms, held, ref_peak

    ref_m, ref_ms, held, ref_peak = s_each_rank(mesh.rank, 2, reference)
    return {"metrics": metrics, "ms": ms, "ref_metrics": ref_m,
            "ref_ms": ref_ms, "held": held, "launches": launches,
            "peak_bytes": peak, "ref_peak_bytes": ref_peak,
            "traffic_per_step": traffic}


def s4_ef_int8(torch, dev, seed: int) -> dict:
    """(s4) the EF-int8 step: (s2)'s cut on pod 2 x data 1 x model 1 with
    compress_pod_axis="pod", without clipping, so that the one-process
    recomputation of the reference's formula (each pod's gradient of its
    rows through grads_and_metrics, flat = g + r in blocks of 256, the
    mean of what was sent, AdamW) must match bit for bit."""
    from repro_torch import optim
    from repro_torch.distributed.sharding import take_block
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import compress
    from repro_torch.train import (grads_and_metrics, local_batch,
                                   shard_state, state_block_specs)
    from repro_torch.tree import flatten, map_with_path

    cfg = s_cfgs(S_ARCH, S_LAYERS)
    tcfg = s_tcfg(S_STEPS, grad_clip=0.0, compress="pod")
    mesh = make_process_mesh(1, 1, pod=2, backend="gloo", device=S_DEVICE)
    gen = torch.Generator(device=dev)
    state = shard_state(init_params(gen.manual_seed(seed), cfg, dev), cfg,
                        tcfg, mesh)
    torch.cuda.empty_cache()
    batch = s_batch(torch, cfg, seed, dev)
    rows = local_batch(batch, mesh)
    wire0 = dict(compress.WIRE_BYTES)
    torch.cuda.reset_peak_memory_stats()
    before = dict(mesh.traffic)
    build.reset_launches()                  # the EF-int8 steps start here
    state, metrics, ms = s_steps(torch, state, rows, cfg, tcfg, S_STEPS, mesh)
    launches = build.launch_counts()        # ... and end here
    peak = torch.cuda.max_memory_allocated()
    traffic = s_traffic(mesh, before, S_STEPS)
    wire = {k: compress.WIRE_BYTES[k] - wire0[k] for k in wire0}
    blocks = s_host(state)
    res_max = max(float(v.abs().max()) for k, v in blocks.items()
                  if k.startswith(".residuals/"))
    del state
    torch.cuda.empty_cache()
    specs = flatten(state_block_specs(cfg, mesh, tcfg))
    pod = mesh.coords["pod"]

    def reference():
        params = init_params(gen.manual_seed(seed), cfg, dev)
        opt = optim.init(params)
        res = [{k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                for k, v in flatten(params).items()} for _ in range(2)]
        halves = [{k: v[2 * p:2 * p + 2] for k, v in batch.items()}
                  for p in range(2)]
        for _ in range(S_STEPS):
            sent = []
            for p in range(2):
                g, _ = grads_and_metrics(params, halves[p], cfg, 1)
                s = {}
                for k, gk in flatten(g).items():
                    flat = gk.float().reshape(-1) + res[p][k].reshape(-1)
                    n = flat.numel()
                    padded = torch.nn.functional.pad(flat, (0, (-n) % 256))
                    s[k] = compress._dequantize(
                        *compress._quantize(padded))[:n]
                    res[p][k] = (flat - s[k]).reshape(gk.shape)
                    s[k] = s[k].reshape(gk.shape)
                del g
                sent.append(s)
            two = torch.tensor(2.0, device=dev)
            reduced = {k: (sent[0][k] + sent[1][k]) / two for k in sent[0]}
            del sent
            params, opt, _ = optim.apply(
                tcfg.optimizer, params,
                map_with_path(lambda k, _: reduced[k], params), opt)
        ref = {**{f".params/{k}": v for k, v in flatten(params).items()},
               **{f".opt/.m/{k}": v for k, v in flatten(opt.m).items()},
               **{f".opt/.v/{k}": v for k, v in flatten(opt.v).items()},
               **{f".residuals/{k}": v for k, v in res[pod].items()}}
        differ = [k for k, blk in blocks.items() if k in ref and not
                  torch.equal(blk.to(dev), take_block(ref[k], specs[k],
                                                      mesh))]
        del params, opt, res, ref
        torch.cuda.empty_cache()
        return differ

    differ = s_each_rank(mesh.rank, 2, reference)
    return {"metrics": metrics, "ms": ms, "launches": launches,
            "wire_bytes": wire, "residual_max_abs": res_max,
            "leaves": len(blocks), "leaves_not_bit_equal": differ,
            "peak_bytes": peak, "traffic_per_step": traffic}


def s5_elastic(torch, dev, seed: int, ckpt: str) -> dict:
    """(s5) (s2)'s checkpoint onto data 1 x model 2 through survive_shrink:
    its first mesh, (s2)'s data 2 x model 2, no longer fits the world of 2
    and is refused; every leaf bit-equal to the saved one, each block of
    the new mesh's shape; then one step on the whole batch."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.fault import survive_shrink
    from repro_torch.distributed.sharding import (shard_shape, take_block,
                                                  train_state_specs)
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.train import local_batch, state_shapes
    from repro_torch.tree import flatten

    cfg = s_cfgs(S_ARCH, S_LAYERS)
    tcfg = s_tcfg(S_STEPS)
    shapes = state_shapes(cfg, tcfg)
    tried = []

    def make_mesh(attempt):
        tried.append(attempt)
        data = 2 if attempt == 0 else 1
        return make_process_mesh(data, 2, backend="gloo", device=S_DEVICE)

    ck = Checkpointer(ckpt)
    t0 = time.perf_counter()
    state, extra, mesh = survive_shrink(ck, cfg, shapes, make_mesh)
    restore_s = time.perf_counter() - t0
    saved, _ = ck.restore(ck.latest_step(), shapes, device="cpu")
    dry = flatten(train_state_specs(cfg, mesh, shapes))
    whole = flatten(shapes)
    got = flatten(state)
    bit_equal = all(torch.equal(got[k].cpu(), take_block(v, dry[k], mesh))
                    for k, v in flatten(saved).items())
    shapes_ok = all(tuple(got[k].shape) == shard_shape(
        tuple(whole[k].shape), dry[k], mesh) for k in got)
    del saved
    rows = local_batch(s_batch(torch, cfg, seed, dev), mesh)
    torch.cuda.reset_peak_memory_stats()
    before = dict(mesh.traffic)
    build.reset_launches()                  # the step after the restore
    state, m, ms = s_steps(torch, state, rows, cfg, tcfg, 1, mesh)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    traffic = s_traffic(mesh, before, 1)
    del state
    torch.cuda.empty_cache()
    return {"attempts": tried, "extra": extra, "restore_s": restore_s,
            "bit_equal": bit_equal, "shapes_ok": shapes_ok, "next": m[0],
            "ms": ms[0], "launches": launches, "peak_bytes": peak,
            "traffic_per_step": traffic}


def s_pair_rank(rank, world, *, seed, ckpt):
    """The world of 2 ranks: (s1), (s3), (s4), (s5), (s7), (s8) and (s9)
    in turn, each with its own process mesh over the same two processes;
    each case's seconds (barrier to barrier) beside its results."""
    import torch.distributed as dist
    torch, dev = s_rank_setup()
    cases = {
        "s1": lambda: s_ep_ffn(torch, dev, seed, S_MOE_ARCH),
        "s3": lambda: s_model_steps(
            torch, dev, seed, s_cfgs(S_MOE_ARCH, S_MOE_LAYERS, "bfloat16"),
            S_MOE_STEPS),
        "s4": lambda: s4_ef_int8(torch, dev, seed),
        "s5": lambda: s5_elastic(torch, dev, seed, ckpt),
        "s7": lambda: s_model_steps(
            torch, dev, seed, s_cfgs(S_MLA_ARCH, S_MLA_LAYERS, "bfloat16"),
            S_MOE_STEPS),
        "s8": lambda: s_ep_ffn(torch, dev, seed, S_MLA_ARCH),
        "s9": lambda: s_model_steps(
            torch, dev, seed, s_cfgs(S_ENCDEC_ARCH, None,
                                     compute_dtype="float32"),
            S_STEPS, frames=S_FRAMES),
    }
    out = {}
    for name, fn in cases.items():
        dist.barrier()
        t0 = time.perf_counter()
        out[name] = dict(fn(), seconds=time.perf_counter() - t0)
    return out


def s_world(target: str, n: int, workdir: Path, backend: str = "gloo",
            timeout: float = S_TIMEOUT, **kwargs) -> list:
    from repro_torch.distributed.world import run_world
    t0 = time.perf_counter()
    out = run_world(f"{S_RANKS_MODULE}:{target}", n, backend=backend,
                    workdir=workdir, kwargs=kwargs, timeout=timeout,
                    python_path=[str(ROOT)])
    log({"world": target, "ranks": n, "backend": backend,
         "seconds": time.perf_counter() - t0})
    return out


def s_rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def s_hold_steps(label: str, got: list, want: list) -> dict:
    """Each step's loss and global norm against the one-process run's,
    within (p)'s bounds."""
    errs = [{"loss_rel_err": s_rel(g["loss"], w["loss"]),
             "grad_norm_rel_err": s_rel(g["grad_norm"], w["grad_norm"])}
            for g, w in zip(got, want)]
    if len(got) != len(want) or any(
            e["loss_rel_err"] > TRAIN_LOSS_RTOL
            or e["grad_norm_rel_err"] > TRAIN_NORM_RTOL for e in errs):
        raise AssertionError(f"phase {label}: steps differ from one "
                             f"process beyond tolerance: {errs}")
    return {"losses": [g["loss"] for g in got],
            "losses_one_process": [w["loss"] for w in want], "errors": errs}


def s_hold_launches(label: str, ranks: list, names) -> dict:
    for r, launches in enumerate(ranks):
        missing = [k for k in names if launches.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"phase {label}: rank {r} did not launch "
                                 f"{missing}")
    return {k: sum(x.get(k, 0) for x in ranks) for k in ranks[0]}


S_FLASH = ("flash_attention", "flash_attention_bwd")


def s_hold_ep(label: str, ranks: list, arch: str, smi: str) -> dict:
    """(s1), (s8): each rank's expert-parallel FFN against one process
    (output within S_Y_TOL of its largest, aux and drops equal, every
    gradient at cosine >= TRAIN_MIN_COS) and its four MoE launches."""
    for r in ranks:
        bad = {k: c for k, c in r["grad_cosines"].items()
               if c < TRAIN_MIN_COS}
        if r["y_err"] > r["y_bound"] or bad or not r["aux_equal"] \
                or not r["dropped_equal"]:
            raise AssertionError(f"phase {label}: {r}")
    launches = s_hold_launches(label, [r["launches"] for r in ranks],
                               MOE_TRAIN_KERNELS)
    log({"check": f"{label}_ep_moe", "arch": arch, "tokens":
         S_BATCH * S_SEQ, "mesh": {"data": 1, "model": 2},
         "ranks": [{k: v for k, v in r.items() if k != "launches"}
                   for r in ranks],
         "tolerance": {"y_share_of_max": S_Y_TOL,
                       "min_cosine": TRAIN_MIN_COS},
         "launches": launches, "card": smi,
         "collectives": "gloo, host-staged loopback"})
    return launches


def s_hold_model(label: str, check: str, ranks: list, arch: str, layers,
                 kernels, smi: str, **extra) -> dict:
    """(s3), (s7), (s9): each rank's sharded steps and blocks against one
    process (as (s2)), every kernel of ``kernels`` launched, no byte
    gathered (data 1: every leaf split over model is computed as the
    rank's block), the ranks' summed peak under 72 GB."""
    for r in ranks:
        held = s_hold_steps(label, r["metrics"], r["ref_metrics"])
        if r["held"]["over"]:
            raise AssertionError(f"phase {label}: {r['held']['over']}")
    launches = s_hold_launches(label, [r["launches"] for r in ranks],
                               kernels)
    s_log_traffic(label, ranks, smi)
    gathered = [r["traffic_per_step"].get("params_gathered", 0)
                for r in ranks]
    if any(gathered):
        raise AssertionError(f"phase {label}: the ranks gathered "
                             f"{gathered} bytes a step over model")
    world_peak = sum(r["peak_bytes"] for r in ranks)
    log({"check": check, "arch": arch, "layers": layers,
         "mesh": {"data": 1, "model": 2}, **extra,
         **held, "leaves_held": [r["held"] for r in ranks],
         "step_ms": [r["ms"] for r in ranks],
         "one_process_step_ms": [r["ref_ms"] for r in ranks],
         "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
         "world_peak_bytes": world_peak,
         "one_process_peak_bytes": [r["ref_peak_bytes"] for r in ranks],
         "launches": launches, "card": smi,
         "collectives": "gloo, host-staged loopback"})
    if world_peak > 72e9:
        raise AssertionError(f"phase {label}: the world's peaks sum to "
                             f"{world_peak / 1e9:.1f} GB")
    return launches


def s_log_traffic(label: str, ranks: list, smi: str) -> None:
    """A world's bytes a step per rank (the parameters gathered, received;
    the gradients put into each form of reduction) and peak memory, one
    line for each rank."""
    for i, r in enumerate(ranks):
        t = r["traffic_per_step"]
        log({"traffic": label, "rank": i,
             "params_gathered_bytes_per_step": t.get("params_gathered", 0),
             "grads_reduce_scatter_bytes_per_step":
                 t.get("grads_reduce_scatter", 0),
             "grads_all_reduce_bytes_per_step": t.get("grads_all_reduce", 0),
             "reduce_form": S_REDUCE_FORM,
             "peak_bytes": r["peak_bytes"], "card": smi})


def collective_path(torch, np, smi: str, seed: int) -> dict:
    """(s) The collective path: worlds of ranks that all share the card
    over gloo, each held against one process on the same card; the
    launcher on NCCL, a world of one. Returns the launches summed over
    every rank of every world."""
    import shutil
    torch.cuda.empty_cache()
    base = ROOT / "build" / "s_worlds"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    launches = []
    log({"phase": "s", "card": smi, "collectives": "gloo over host "
         "loopback (one card: no NCCL world of two ranks, no NVLink)"})
    try:
        # NCCL refuses two ranks on one card; the error stands.
        refused = s_world("s_nccl_rank", 2, base / "nccl", backend="nccl")
        if not all(r["refused"] for r in refused):
            raise AssertionError("phase s: NCCL took two ranks on one card")
        log({"check": "s_nccl_duplicate_gpu", "ranks": refused})

        ckpt = str(base / "ckpt")
        four = s_world("s2_rank", 4, base / "s2", seed=seed, ckpt=ckpt)
        for r in four:
            held = s_hold_steps("s2", r["metrics"], r["ref_metrics"])
            if r["held"]["over"] or not r["shapes_ok"]:
                raise AssertionError(f"phase s2: rank {r['coords']}: "
                                     f"{r['held']['over']} shapes_ok="
                                     f"{r['shapes_ok']}")
            mb = s_hold_steps("s2 microbatches", [r["microbatched"]],
                              [r["ref_microbatched"]])
        launches.append(s_hold_launches("s2", [r["launches"] for r in four],
                                        S_FLASH))
        s_log_traffic("s2", four, smi)
        log({"check": "s2_sharded_step", "arch": S_ARCH,
             "layers": S_LAYERS, "mesh": {"data": 2, "model": 2},
             "batch": [S_BATCH, S_SEQ], **held,
             "leaves_held": [r["held"] for r in four],
             "step_ms": [r["ms"] for r in four],
             "one_process_step_ms": [r["ref_ms"] for r in four],
             "peak_bytes_per_rank": [r["peak_bytes"] for r in four],
             "block_bytes_per_rank": [r["block_bytes"] for r in four],
             "save_s": four[0]["save_s"], "launches": launches[-1],
             "next_loss": four[0]["next"]["loss"],
             "next_loss_one_process": four[0]["ref_next"]["loss"],
             "card": smi, "collectives": "gloo, host-staged loopback"})
        log({"check": "s2_microbatches", "microbatches": S_MICROBATCHES,
             "loss": mb["losses"][0],
             "loss_one_process": mb["losses_one_process"][0],
             "errors": mb["errors"][0],
             "grad_norm": four[0]["microbatched"]["grad_norm"],
             "grad_norm_one_process":
                 four[0]["ref_microbatched"]["grad_norm"],
             "step_ms": [r["microbatched_ms"] for r in four], "card": smi})

        pair = s_world("s_pair_rank", 2, base / "pair", seed=seed,
                       ckpt=ckpt, timeout=S_PAIR_TIMEOUT)
        launches.append(s_hold_ep("s1", [r["s1"] for r in pair],
                                  S_MOE_ARCH, smi))
        launches.append(s_hold_model(
            "s3", "s3_moe_step", [r["s3"] for r in pair], S_MOE_ARCH,
            S_MOE_LAYERS, MOE_TRAIN_KERNELS + S_FLASH, smi))
        s4 = [r["s4"] for r in pair]
        for r in s4:
            if r["leaves_not_bit_equal"]:
                raise AssertionError(f"phase s4: not bit-equal: "
                                     f"{r['leaves_not_bit_equal'][:8]}")
        if s4[0]["metrics"] != s4[1]["metrics"]:
            raise AssertionError("phase s4: the pods disagree on metrics")
        launches.append(s_hold_launches("s4", [r["launches"] for r in s4],
                                        S_FLASH))
        s_log_traffic("s4", s4, smi)
        log({"check": "s4_ef_int8", "arch": S_ARCH, "layers": S_LAYERS,
             "mesh": {"pod": 2, "data": 1, "model": 1},
             "losses": [m["loss"] for m in s4[0]["metrics"]],
             "grad_norms": [m["grad_norm"] for m in s4[0]["metrics"]],
             "leaves_bit_equal": s4[0]["leaves"],
             "residual_max_abs": [r["residual_max_abs"] for r in s4],
             "wire_bytes_per_rank": s4[0]["wire_bytes"],
             "wire_ratio": s4[0]["wire_bytes"]["int8"]
             / s4[0]["wire_bytes"]["fp32"],
             "step_ms": [r["ms"] for r in s4], "launches": launches[-1],
             "card": smi, "collectives": "gloo, host-staged loopback"})
        s5 = [r["s5"] for r in pair]
        for r in s5:
            if r["attempts"] != [0, 1] or not r["bit_equal"] \
                    or not r["shapes_ok"]:
                raise AssertionError(f"phase s5: {r}")
        want = four[0]["next"]["loss"]
        err = s_rel(s5[0]["next"]["loss"], want)
        if err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"phase s5: the step after the restore "
                                 f"gave {s5[0]['next']['loss']}, (s2)'s "
                                 f"world {want}")
        launches.append(s_hold_launches("s5", [r["launches"] for r in s5],
                                        S_FLASH))
        s_log_traffic("s5", s5, smi)
        log({"check": "s5_elastic", "from": {"data": 2, "model": 2},
             "to": {"data": 1, "model": 2}, "attempts": s5[0]["attempts"],
             "restore_s": [r["restore_s"] for r in s5],
             "next_loss": s5[0]["next"]["loss"], "s2_world_next_loss": want,
             "loss_rel_err": err, "step_ms": [r["ms"] for r in s5],
             "launches": launches[-1], "card": smi})
        # MLA's heads, the shared expert and the encoder-decoder split
        # over model: no byte gathered at data 1.
        launches.append(s_hold_model(
            "s7", "s7_mla_step", [r["s7"] for r in pair], S_MLA_ARCH,
            S_MLA_LAYERS, S_FLASH, smi))
        launches.append(s_hold_ep("s8", [r["s8"] for r in pair],
                                  S_MLA_ARCH, smi))
        launches.append(s_hold_model(
            "s9", "s9_encdec_step", [r["s9"] for r in pair], S_ENCDEC_ARCH,
            None, S_FLASH, smi, frames=S_FRAMES, compute="float32"))
        log({"check": "s_pair_cases",
             "seconds": {k: [r[k]["seconds"] for r in pair]
                         for k in pair[0]}, "card": smi})

        # (s6) The launcher's flags on NCCL, a world of one on the card.
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
             "--arch", S_ARCH, "--layers", "1", "--distributed-init",
             "--mesh-data", "1", "--steps", "2", "--global-batch",
             str(S_BATCH), "--seq-len", str(S_SEQ),
             "--device", S_DEVICE.split(":")[0],
             "--ckpt-dir", str(base / "launcher_ckpt")],
            capture_output=True, text=True, env=env, timeout=S_TIMEOUT,
            cwd=str(base))
        if proc.returncode != 0 or "finished at step 2" not in proc.stdout:
            raise AssertionError(f"phase s6: the launcher exited "
                                 f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        log({"check": "s6_launcher_nccl", "backend": "nccl", "world": 1,
             "seconds": time.perf_counter() - t0,
             "stdout_tail": proc.stdout.strip().splitlines()[-1:]})
    finally:
        shutil.rmtree(base, ignore_errors=True)
    total = {}
    for d in launches:
        for k, n in d.items():
            total[k] = total.get(k, 0) + n
    return total


# ---------------------------------------------------------------------------
# Phase (t): flash over the rest of the reference's attention domain
# ---------------------------------------------------------------------------

#: (t1) The reduced configs' head dims against the plain versions, each
#: without a cap and under T_CAPS: B, S or (Sq, Sk), H, KV, D, DV, causal,
#: window. gemma3-12b's reduced window of 16 crosses tile edges; G 1 and
#: G > 1; deepseek-v2-236b's reduced MLA heads of 24 over 16. The last
#: eight cross the narrow kernels' tiles (128 keys a dK/dV block, 128
#: queries a pair and a dQ block, 128 keys a dQ stage): S and Sk not
#: multiples of 128 (2,085, 129, 255), Sq != Sk, G 1, 4 and 8, windows of
#: 16 and 100.
T_NARROW_CASES = [
    (2, 200, 8, 2, 16, 16, True, None),       # qwen2.5-3b's reduced heads
    (1, (64, 300), 4, 4, 16, 16, False, None),
    (2, 300, 4, 2, 24, 24, True, 16),         # gemma3-12b's reduced window
    (1, 333, 4, 4, 24, 24, False, None),
    (2, 200, 4, 4, 24, 16, True, None),       # deepseek-v2's reduced MLA
    (1, (100, 150), 4, 4, 24, 16, False, 32),
    (2, 257, 8, 4, 32, 32, True, None),       # qwen3-14b's reduced heads
    (1, 300, 4, 4, 32, 32, True, 100),
    (1, 2085, 8, 1, 16, 16, True, None),      # G 8 over 17 tiles
    (2, (129, 255), 4, 4, 16, 16, True, 16),
    (1, (255, 129), 8, 2, 24, 24, False, None),
    (1, 2085, 4, 1, 24, 24, True, 100),       # G 4
    (2, 255, 4, 4, 24, 16, True, 16),         # G 1
    (1, (129, 2085), 4, 4, 24, 16, False, 100),
    (1, (255, 129), 8, 1, 32, 32, True, None),
    (2, 129, 4, 2, 32, 32, True, 100),
]
#: The cap at the published head dims (MLA's 192/128 takes none).
T_CAP_CASES = [
    (2, 300, 8, 2, 64, 64, True, None),
    (1, 333, 8, 8, 96, 96, True, 100),
    (2, 512, 16, 2, 128, 128, True, None),
    (1, 777, 8, 4, 256, 256, True, 100),
    (2, (64, 300), 4, 2, 256, 256, False, None),
]
#: A cap that barely bites at these scores and one that makes the cap's
#: derivative matter (Gemma 2's published attn_logit_softcapping is 50).
T_CAPS = (50.0, 5.0)
#: q is scaled so that the scores reach about +-10.
T_Q_SCALE = 4.0
#: (t2) gemma3-12b's geometry under Gemma 2's published logit softcap: its
#: prefill of 2 x 2,048 uncut as in (o), one period trained on 2 x 2,048 as
#: in (q).
T_SOFTCAP = 50.0
T_FAMILY = Family("gemma3-12b", None, 2, 2048, 8, param_dtype="bfloat16",
                  softcap=T_SOFTCAP)
T_TRAIN_FAMILY = TrainFamily("gemma3-12b", 6, "bfloat16", Q_STEPS, batch=2,
                             seq=2048, softcap=T_SOFTCAP)
#: Rows 7f and 7g with the cap beside without: gemma3-12b's prefill and
#: training shapes (label, B, S, H, KV, D, DV, window), bf16, causal.
T_CAP_TIMED = [("gemma3-12b", 2, 2048, 16, 8, 256, 256, None),
               ("gemma3-12b local", 2, 2048, 16, 8, 256, 256, 1024)]
#: Rows 7h and 7i: the narrow pairs at the training launcher's batch (8 x
#: 64 tokens, the reduced configs' heads), where launches dominate, and at
#: S 2,048 (B 4, 16 heads), where the kernels' own work shows.
T_TIMED = [("qwen2.5-3b reduced", 8, 64, 4, 2, 16, 16, None),
           ("gemma3-12b reduced local", 8, 64, 4, 2, 24, 24, 16),
           ("deepseek-v2-236b reduced", 8, 64, 4, 4, 24, 16, None),
           ("qwen3-14b reduced", 8, 64, 4, 2, 32, 32, None),
           ("16 at S 2,048", 4, 2048, 16, 4, 16, 16, None),
           ("24 at S 2,048", 4, 2048, 16, 4, 24, 24, None),
           ("24/16 at S 2,048", 4, 2048, 16, 16, 24, 16, None),
           ("32 at S 2,048", 4, 2048, 16, 4, 32, 32, None)]
#: (t3) Every registered arch's reduced config through the launchers.
T_ARCHS = ("qwen2.5-3b", "qwen3-14b", "gemma3-12b", "starcoder2-15b",
           "dbrx-132b", "deepseek-v2-236b", "jamba-v0.1-52b", "mamba2-780m",
           "seamless-m4t-medium", "phi-3-vision-4.2b")
T_TRAIN_STEPS = 3
T_BATCH, T_SEQ = 8, 64     # the training launcher's global batch and length
#: The training launcher's data pipeline makes no encoder frames, in the
#: port as in the reference (``python -m repro.launch.train --arch
#: seamless-m4t-medium --reduced`` raises KeyError 'frames' too): the
#: encoder-decoder's reduced config trains through ``train_family_run`` on
#: stub frames instead, held against the plain ops.
T_FRAMES_ARCH = "seamless-m4t-medium"
T_FRAMES = 32
T_LAUNCHER_TIMEOUT = 600
#: (t3) The reduced forward in fp32 compute against the plain ops: the fp32
#: kernels agree within 2e-5, a few layers widen that.
T_FP32_TOL = 1e-3


def check_flash_domain(torch, np, dev, rng) -> dict:
    """(t1) Flash forward and backward at the reduced configs' head dims,
    without a cap and under T_CAPS, and under T_CAPS at 64, 96, 128 and
    256, in fp32 and bf16, against the plain versions: the forward within
    rtol = atol = 2e-5 (fp32) and 2e-2 (bf16), the log-sum-exp within
    1e-3, the backward within FLASH_BWD_TOL of each reference's largest
    entry and bit-identical across two launches. MLA's (192, 128) must
    refuse a cap. Returns the largest bf16 errors."""
    from repro_torch.kernels.flash_attention import (
        _forward, flash_attention, flash_attention_backward,
        flash_attention_backward_plain, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    cases = [(c, cap) for c in T_NARROW_CASES for cap in (None,) + T_CAPS]
    cases += [(c, cap) for c in T_CAP_CASES for cap in T_CAPS]
    worst = {"forward": 0.0, "backward": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        btol = FLASH_BWD_TOL[str(dtype).split(".")[-1]]
        for (b, s, h, kv, d, dv, causal, window), cap in cases:
            sq, sk = s if isinstance(s, tuple) else (s, s)
            q = torch.randn((b, sq, h, d), device=dev, generator=g) \
                * T_Q_SCALE
            k = torch.randn((b, sk, kv, d), device=dev, generator=g)
            v = torch.randn((b, sk, kv, dv), device=dev, generator=g)
            do = torch.randn((b, sq, h, dv), device=dev, generator=g)
            q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
            kw = dict(causal=causal, window=window, softcap=cap)
            want = flash_attention_plain(q, k, v, **kw)
            got = flash_attention(q, k, v, **kw)
            out, lse = _forward(q, k, v, causal, window, with_lse=True,
                                softcap=cap)
            _, lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)
            seen = lse_p > -1e29
            bwant = flash_attention_backward_plain(q, k, v, out, lse, do,
                                                   **kw)
            bgot = flash_attention_backward(q, k, v, out, lse, do, **kw)
            again = flash_attention_backward(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            within = bool((diff <= tol + tol * want.float().abs()).all())
            lse_err = max_err(torch, lse[seen], lse_p[seen])
            rel = [max_err(torch, x, y) / max(float(y.float().abs().max()),
                                              1e-30)
                   for x, y in zip(bgot, bwant)]
            identical = all(torch.equal(x, z) for x, z in zip(bgot, again))
            spec = {"dtype": str(dtype), "B": b, "S": s, "H": h, "KV": kv,
                    "D": d, "DV": dv, "causal": causal, "window": window,
                    "softcap": cap}
            log({"check": "t_flash", **spec,
                 "forward_max_abs_err": float(diff.max()), "rtol": tol,
                 "atol": tol, "lse_max_abs_err": lse_err,
                 "backward_rel_err_dq_dk_dv": rel, "backward_tol": btol,
                 "bit_identical_across_launches": identical})
            if not within or lse_err > 1e-3 or max(rel) > btol \
                    or not identical:
                raise AssertionError(f"phase t: flash disagrees at {spec}: "
                                     f"forward {float(diff.max())}, lse "
                                     f"{lse_err}, backward {rel}, "
                                     f"identical {identical}")
            if dtype == torch.bfloat16:
                worst["forward"] = max(worst["forward"], float(diff.max()))
                worst["backward"] = max(worst["backward"], max(
                    max_err(torch, x, y) for x, y in zip(bgot, bwant)))
            del q, k, v, do, want, got, out, lse, lse_p, bwant, bgot, again
    q = torch.zeros((1, 16, 2, 192), device=dev, dtype=torch.bfloat16)
    try:
        flash_attention(q, q, q[..., :128].contiguous(), softcap=5.0)
    except ValueError as e:
        log({"check": "t_flash_mla_refuses_a_cap", "error": str(e)})
    else:
        raise AssertionError("phase t: flash took a cap at (192, 128)")
    torch.cuda.empty_cache()
    return worst


def time_flash_domain(torch, dev, smi: str) -> list:
    """Flash forward and backward at T_TIMED (rows 7h, 7i) and, with the
    cap beside without, at T_CAP_TIMED (rows 7f, 7g), bf16, causal: the
    wrappers, the bare launches, the plain versions and SDPA at the same
    shape (uncapped: SDPA takes no cap), beside the bound (the cap's tanh
    on the special-function unit is not counted)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        _forward, _visible, bwd_scratch_floats, flash_attention,
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stream = torch.cuda.current_stream().cuda_stream
    specs = [(spec, None) for spec in T_TIMED]
    specs += [(spec, cap) for spec in T_CAP_TIMED
              for cap in (None, T_SOFTCAP)]
    rows = []
    for (label, b, s, h, kv, d, dv, window), cap in specs:
        q, k, do = (torch.randn(shape, device=dev, generator=g)
                    .to(torch.bfloat16)
                    for shape in ((b, s, h, d), (b, s, kv, d), (b, s, h, dv)))
        v = torch.randn((b, s, kv, dv), device=dev, generator=g) \
            .to(torch.bfloat16)
        kw = dict(causal=True, window=window, softcap=cap)
        args = (b, s, s, h, kv, d, dv, 1, window or 0, 1, cap or 0.0, stream)
        o = q.new_empty((b, s, h, dv))
        out, lse = _forward(q, k, v, True, window, with_lse=True,
                            softcap=cap)
        dq, dk, dvv = (torch.empty_like(x) for x in (q, k, v))
        scratch = torch.empty(bwd_scratch_floats(b, s, h),
                              dtype=torch.float32, device=dev)
        fwd = {"ms": time_ms(torch, lambda: flash_attention(q, k, v, **kw)),
               "kernel_ms": time_ms(torch, lambda: build.launch(
                   "flash_attention", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), None, *args)),
               "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                   q, k, v, **kw), reps=3, warm=1)}
        bwd = {"ms": time_ms(torch, lambda: flash_attention_backward(
                   q, k, v, out, lse, do, **kw)),
               "kernel_ms": time_ms(torch, lambda: build.launch(
                   "flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dvv.data_ptr(), *args)),
               "plain_ms": time_ms(torch, lambda: flash_attention_backward_plain(
                   q, k, v, out, lse, do, **kw), reps=3, warm=1)}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_kw = dict(is_causal=True) if window is None else dict(
            attn_mask=_visible(s, s, True, window, dev))
        try:
            o_lib = sdpa(qt, kt, vt, enable_gqa=h != kv, **lib_kw)
            fwd["library_ms"] = time_ms(torch, lambda: sdpa(
                qt, kt, vt, enable_gqa=h != kv, **lib_kw))
            bwd["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
            lib_error = None
        except RuntimeError as e:              # SDPA refuses the shape
            fwd["library_ms"] = bwd["library_ms"] = o_lib = None
            lib_error = str(e)[:200]
        for part, t, work in (
                ("forward", fwd, flash_work(q, k, True, v, window)),
                ("backward", bwd, flash_bwd_work(q, k, v, True, window))):
            b_ms, b_by = bound_ms(*work, BF16_TC_OPS_PER_S)
            t.update(bound_ms=b_ms, bound_by=b_by, bytes=work[0],
                     operations=work[1])
            row = {"model": label, "part": part, "B": b, "S": s, "H": h,
                   "KV": kv, "D": d, "DV": dv, "causal": True,
                   "window": window, "softcap": cap, "dtype": "bfloat16",
                   **t, "kernel_share_of_bound": b_ms / t["kernel_ms"],
                   "library": "scaled_dot_product_attention (no cap)",
                   "library_error": lib_error, "card": smi}
            log({"time": "t_flash", **row})
            rows.append(row)
        del q, k, v, do, o, out, lse, dq, dk, dvv, scratch, qt, kt, vt, o_lib
        torch.cuda.empty_cache()
    return rows


def bwd_launch_lines(torch, dev, smi: str) -> None:
    """Each kernel of one bf16 backward launch at T_TIMED's narrow S 2,048
    shapes (the Delta pass, dK/dV, dQ), with its device time and its start
    and end from the first kernel's, in microseconds: a
    ``t_flash_bwd_launches`` line each."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_ab import kernel_timeline
    from repro_torch.kernels.flash_attention import _forward, \
        bwd_scratch_floats

    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, b, s, h, kv, d, dv, window in T_TIMED:
        if s < 2048 or d > 32:
            continue
        q, k, v, do = (torch.randn(shape, device=dev, generator=g)
                       .to(torch.bfloat16)
                       for shape in ((b, s, h, d), (b, s, kv, d),
                                     (b, s, kv, dv), (b, s, h, dv)))
        out, lse = _forward(q, k, v, True, window, with_lse=True)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        scratch = torch.empty(bwd_scratch_floats(b, s, h),
                              dtype=torch.float32, device=dev)
        timeline = kernel_timeline(lambda: build.launch(
            "flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            *(x.data_ptr() for x in grads), b, s, s, h, kv, d, dv, 1,
            window or 0, 1, 0.0, stream))
        log({"time": "t_flash_bwd_launches", "model": label, "B": b, "S": s,
             "H": h, "KV": kv, "D": d, "DV": dv,
             "device_us_start_end": [(bwd_kernel(name), us, start, end)
                                     for name, us, start, end in timeline],
             "card": smi})
        del q, k, v, do, out, lse, grads, scratch


def time_bwd_launches(smi: str) -> None:
    """bwd_launch_lines in a process of its own on the card (the libraries
    already built), its lines logged here: late in the smoke's process the
    profiler comes back without the port's kernels, which a fresh process
    returns. A measurement, not a check: where the profiler sees no kernel
    (CUPTI refused), a line says so and the smoke goes on."""
    code = ("import torch, chip_smoke as cs; "
            f"cs.bwd_launch_lines(torch, torch.device('cuda', 0), {smi!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=T_LAUNCHER_TIMEOUT)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith('{"time": "t_flash_bwd_launches"')]
    for line in lines:
        log(line)
    if proc.returncode or not lines or not all(
            ln["device_us_start_end"] for ln in lines):
        log({"time": "t_flash_bwd_launches", "error": "no kernels seen",
             "returncode": proc.returncode, "lines": len(lines),
             "stderr_tail": proc.stderr[-1500:]})


def reduced_model_run(torch, np, dev, rng, seed: int, arch: str) -> dict:
    """(t3) One arch's reduced config on the card: the serving launcher (8
    requests, every one delivered), the training launcher (T_TRAIN_STEPS
    steps, finite losses; the encoder-decoder through train_family_run, see
    T_FRAMES_ARCH), then its forward and loss on one batch of T_BATCH x
    T_SEQ tokens through the kernels (launches as the config implies) held
    against the same on the plain ops, the dispatch plans replayed, in fp32
    compute (logits within T_FP32_TOL, loss within 1e-5 relative) and in
    the config's bf16 (logits within the larger of LOGIT_TOL and twice the
    plain bf16 forward's distance from the plain fp32 one, loss within
    2e-3). Returns the launches of all three and the seconds of each."""
    import io
    import shutil
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.models import forward, init_params, loss_fn

    total = Counter()
    build.reset_launches()                    # the arch's path starts here
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launch.main(["--arch", arch, "--reduced", "--seed", str(seed)])
    total.update(build.launch_counts())
    said = out.getvalue().splitlines()[0]
    if not said.startswith("8/8 requests"):
        raise AssertionError(f"phase t {arch}: the serving launcher said "
                             f"{said!r}")
    serve_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if arch == T_FRAMES_ARCH:
        run = train_family_run(torch, np, dev, rng, seed, TrainFamily(
            arch, None, "float32", T_TRAIN_STEPS, frames=T_FRAMES,
            grads_compute="float32", batch=T_BATCH, seq=T_SEQ, reduced=True))
        total.update(run["launches"])
        losses = run["losses"]
    else:
        ckpt = ROOT / "build" / "t_ckpt"
        build.reset_launches()
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                result = train_launch.main([
                    "--arch", arch, "--reduced", "--steps",
                    str(T_TRAIN_STEPS), "--global-batch", str(T_BATCH),
                    "--seq-len", str(T_SEQ), "--ckpt-dir", str(ckpt)])
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        total.update(build.launch_counts())
        losses = result["losses"]
        if result["final_step"] != T_TRAIN_STEPS \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"phase t {arch}: the training launcher "
                                 f"ended at {result['final_step']}, losses "
                                 f"{losses}")
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = get_config(arch, reduced=True)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    batch = train_batch(torch, np, dev, rng, cfg, TrainFamily(
        arch, None, cfg.param_dtype, 0,
        frames=T_FRAMES if cfg.is_encdec else 0, batch=T_BATCH, seq=T_SEQ),
        seed)
    def run(compute, plans=None):
        """(logits, loss, launches) in ``compute``: through the kernels,
        recording the dispatch plans into ``plans``; or, given an iterator
        ``plans``, on the plain ops with those plans replayed."""
        ccfg = dataclasses.replace(cfg, compute_dtype=compute)
        before = build.launch_counts()
        ctx = recording_plans(record) if plans is None else plain_kernels(
            torch, plans, [])
        with torch.no_grad(), ctx:
            logits = forward(params, batch, ccfg)[0].float()
            loss = float(loss_fn(params, batch, ccfg)[0])
        torch.cuda.synchronize()
        after = build.launch_counts()
        return logits, loss, {k: after[k] - before[k] for k in after}

    for compute in ("float32", cfg.compute_dtype):
        record = []
        logits, loss, launches = run(compute)
        total.update(launches)
        expect_launches(f"t {arch} forward and loss", launches,
                        family_launches(cfg, 0)[0])
        logits_p, loss_p, none = run(compute, iter(record))
        if any(none.values()):
            raise AssertionError(f"phase t {arch}: the plain forward "
                                 f"launched {none}")
        # fp32 compute: the kernels within T_FP32_TOL of the plain ops.
        # bf16: within the larger of LOGIT_TOL and twice the distance of the
        # plain bf16 forward from the plain fp32 one on the same routing (a
        # reduced net's narrow layers widen one bf16 rounding into several
        # ulps of a logit).
        own = None
        tol = T_FP32_TOL
        if compute != "float32":
            own = max_err(torch, logits_p, run("float32", iter(record))[0])
            tol = max(LOGIT_TOL, 2 * own)
        close = hold_close(torch, f"phase t {arch}: reduced logits in "
                           f"{compute} against the plain forward", logits,
                           logits_p, tol)
        loss_rel = abs(loss - loss_p) / max(abs(loss_p), 1e-30)
        if not np.isfinite(loss) \
                or loss_rel > (2e-3 if own is not None else 1e-5):
            raise AssertionError(f"phase t {arch}: loss {loss} in {compute} "
                                 f"against the plain ops' {loss_p}")
        log({"check": f"t3_{arch}_forward_vs_plain", "compute": compute,
             **close, "plain_bf16_vs_plain_fp32": own, "loss": loss,
             "plain_loss": loss_p, "loss_rel_err": loss_rel,
             "launches": {k: n for k, n in launches.items() if n}})
    del logits, logits_p
    del params, batch
    torch.cuda.empty_cache()
    return {"launches": dict(total), "serve_seconds": serve_s,
            "train_seconds": train_s,
            "forward_seconds": time.perf_counter() - t0, "losses": losses}


def launcher_subprocess() -> dict:
    """(t3) ``python -m repro_torch.launch.train --arch qwen2.5-3b --reduced
    --steps 3``, the reference's documented start, in a process of its own
    on the card (its checkpoint under a TMPDIR in build/, removed after)."""
    import shutil
    tmp = ROOT / "build" / "t_tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2.5-3b", "--reduced", "--steps", "3"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=T_LAUNCHER_TIMEOUT)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"command": " ".join(cmd[1:]), "returncode": proc.returncode,
           "seconds": time.perf_counter() - t0,
           "stdout_tail": proc.stdout[-200:]}
    if proc.returncode or "finished at step 3" not in proc.stdout:
        raise AssertionError(f"phase t: {out}, stderr "
                             f"{proc.stderr[-1500:]}")
    return out


def domain_path(torch, np, dev, rng, seed: int, smi: str) -> tuple:
    """(t) Flash over the rest of the reference's attention domain: (t1)
    the reduced configs' head dims and the cap against the plain versions;
    (t2) gemma3-12b at full width under a cap of T_SOFTCAP, prefilled as in
    (o) and trained as in (q); (t3) every registered arch's reduced config
    through the launchers on the card, and the training launcher in a
    process of its own; then rows 7f-7i timed (the backward's launches at
    rows 7i's S 2,048 shapes first). Returns the launches of
    (t2) and (t3), flash's by shape, and the timing."""
    from collections import Counter

    from repro_torch.kernels.flash_attention import LAUNCHES_BY_SHAPE, \
        shape_key
    time_bwd_launches(smi)
    t0 = time.perf_counter()
    worst = check_flash_domain(torch, np, dev, rng)
    log({"phase": "t1", "seconds": time.perf_counter() - t0})
    total, shapes = Counter(), Counter()
    t0 = time.perf_counter()
    run = family_run(torch, np, dev, rng, seed, T_FAMILY)
    total.update(run["launches"])
    shapes.update(run["flash_by_shape"])
    torch.cuda.empty_cache()
    LAUNCHES_BY_SHAPE.clear()
    run = train_family_run(torch, np, dev, rng, seed, T_TRAIN_FAMILY)
    total.update(run["launches"])
    shapes.update(LAUNCHES_BY_SHAPE)          # its profiled step included
    torch.cuda.empty_cache()
    log({"phase": "t2", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    for arch in T_ARCHS:
        t_a = time.perf_counter()
        LAUNCHES_BY_SHAPE.clear()
        run = reduced_model_run(torch, np, dev, rng, seed, arch)
        total.update(run["launches"])
        shapes.update(LAUNCHES_BY_SHAPE)
        log({"phase": f"t3_{arch}", "seconds": time.perf_counter() - t_a,
             **{k: v for k, v in run.items() if k != "launches"},
             "launches": {k: n for k, n in run["launches"].items() if n}})
    log({"check": "t3_launcher_subprocess", **launcher_subprocess()})
    log({"phase": "t3", "seconds": time.perf_counter() - t0})
    from repro_torch.configs import get_config
    want = [shape_key(d, dv, True) for d, dv in FLASH_DIMS[:4]] + [
        shape_key(*flash_dims(get_config(T_FAMILY.arch)), True, T_SOFTCAP)]
    missing = [k for k in want if not shapes.get(k)]
    if missing or not total["flash_attention_bwd"]:
        raise AssertionError(f"phase t: flash never launched at {missing} "
                             f"(by shape {dict(shapes)}) or its backward "
                             f"{total['flash_attention_bwd']} times")
    t0 = time.perf_counter()
    rows = time_flash_domain(torch, dev, smi)
    log({"phase": "t_timing", "seconds": time.perf_counter() - t0})
    return dict(total), dict(shapes), {"max_abs_err": worst, "timed": rows}


# ---------------------------------------------------------------------------
# Phase (u): AdamW's kernels at the trained configurations' largest leaves
# ---------------------------------------------------------------------------

#: (label, shape, parameter dtype, gradient dtype): dbrx-132b's expert
#: leaf (16 experts' w_up, bf16) and qwen2.5-3b's embedding (fp32), the
#: largest leaf of each configuration the benchmark trains.
ADAMW_LEAVES = (("dbrx-132b expert leaf", (16, 6144, 10752), "bfloat16",
                 "bfloat16"),
                ("qwen2.5-3b embedding", (151936, 2048), "float32",
                 "float32"))
#: The sum of squares against a float64 sum of the same leaf: fp32 tree
#: sums over up to 1.06 B elements.
SUMSQ_RTOL = 1e-5
#: fp32 operations an element of the update (17) and of the sum (2).
ADAMW_OPS, SUMSQ_OPS = 17, 2


def check_adamw(torch, np, dev, rng) -> dict:
    """(u) Both AdamW kernels at each of ADAMW_LEAVES: one update against
    the plain body (p, m and v with ``torch.equal``), the sum of squares
    within SUMSQ_RTOL of a float64 sum and the same bits on a second call,
    each wrapper's launches counted; then the wrapper, the bare launch and
    the plain version of each timed beside the bound of its bytes, and
    for the sum two library norms in fp32 (their bits over two calls and
    their squares against the float64 sum printed). Returns both kernels'
    rows, timed at the first leaf, each leaf's in ``leaves``."""
    from repro_torch import optim
    from repro_torch.kernels import adamw, build
    from repro_torch.kernels.descriptor_copy import stream_of

    ocfg = optim.AdamWConfig()
    consts = {"b1": ocfg.b1, "b2": ocfg.b2, "eps": ocfg.eps,
              "weight_decay": ocfg.weight_decay}
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    stream = stream_of(dev)
    rows = {k: [] for k in ADAMW_KERNELS}
    for label, shape, p_name, g_name in ADAMW_LEAVES:
        p_dtype, g_dtype = getattr(torch, p_name), getattr(torch, g_name)

        def draw(dtype, std):
            return torch.empty(shape, dtype=dtype, device=dev).normal_(
                0.0, std, generator=g)
        p, gr = draw(p_dtype, 0.02), draw(g_dtype, 1e-3)
        m, v = draw(torch.float32, 1e-4), draw(torch.float32, 1e-4).square_()
        # The clip's scale, lr and the bias corrections at step 3.
        scalars = tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                        for x in (0.5, 3.3e-5, 1 - ocfg.b1 ** 3,
                                  1 - ocfg.b2 ** 3))
        n = p.numel()
        want = [t.clone() for t in (p, m, v)]
        adamw.adamw_update_plain(want[0], gr, want[1], want[2], *scalars,
                                 **consts)
        before = build.launch_counts()
        adamw.adamw_update(p, gr, m, v, *scalars, **consts)
        total, again = adamw.sum_squares([gr]), adamw.sum_squares([gr])
        torch.cuda.synchronize()
        launched = {k: c - before[k] for k, c in build.launch_counts().items()
                    if c != before[k]}
        equal = {k: torch.equal(a, b) for k, a, b in zip("pmv", (p, m, v),
                                                         want)}
        del want
        flat = gr.reshape(-1)
        exact = sum(float(flat[i:i + (1 << 26)].double().square().sum())
                    for i in range(0, n, 1 << 26))
        rel = abs(float(total) - exact) / exact
        library = {
            "_foreach_norm": lambda: torch._foreach_norm(
                [gr], 2, dtype=torch.float32)[0],
            "vector_norm": lambda: torch.linalg.vector_norm(
                gr, dtype=torch.float32)}
        lib_out = {k: (f(), f()) for k, f in library.items()}
        log({"check": "u_adamw", "leaf": label, "shape": list(shape),
             "elements": n, "dtypes": [p_name, g_name],
             "update_equal": equal, "sum_squares_rel_err": rel,
             "tolerance": SUMSQ_RTOL,
             "sum_squares_same_bits_twice": torch.equal(total, again),
             "launches": launched,
             "library_norm_squared_rel_err": {
                 k: abs(float(a) ** 2 - exact) / exact
                 for k, (a, _) in lib_out.items()},
             "library_same_bits_twice": {
                 k: torch.equal(a, b) for k, (a, b) in lib_out.items()}})
        if not all(equal.values()) or rel > SUMSQ_RTOL \
                or not torch.equal(total, again) \
                or launched != {"adamw_update": 1, "sum_squares": 4}:
            raise AssertionError(f"phase u {label}: the AdamW kernels "
                                 "disagree with their plain versions or "
                                 f"launched {launched}")
        del lib_out

        codes = (adamw._DTYPE_CODE[p_dtype], adamw._DTYPE_CODE[g_dtype])
        partial = torch.empty(adamw.blocks(n), dtype=torch.float32,
                              device=dev)
        u_bytes = n * (2 * p.element_size() + gr.element_size() + 16)
        u_bound, u_by = bound_ms(u_bytes, ADAMW_OPS * n)
        update = {
            "max_abs_err": 0.0,
            "ms": time_ms(torch, lambda: adamw.adamw_update(
                p, gr, m, v, *scalars, **consts)),
            "kernel_ms": time_ms(torch, lambda: build.launch(
                "adamw_update", p.data_ptr(), gr.data_ptr(), m.data_ptr(),
                v.data_ptr(), n, *codes, *(x.data_ptr() for x in scalars),
                *consts.values(), stream)),
            "plain_ms": time_ms(torch, lambda: adamw.adamw_update_plain(
                p, gr, m, v, *scalars, **consts)),
            "library_ms": None, "bound_ms": u_bound, "bound_by": u_by,
            "bytes": u_bytes}
        s_bytes = n * gr.element_size()
        s_bound, s_by = bound_ms(s_bytes, SUMSQ_OPS * n)
        lib_ms = {k: time_ms(torch, f) for k, f in library.items()}
        sumsq = {
            "max_abs_err": abs(float(total) - exact),
            "ms": time_ms(torch, lambda: adamw.sum_squares([gr])),
            "kernel_ms": time_ms(torch, lambda: build.launch(
                "sum_squares", gr.data_ptr(), n, codes[1], 1,
                partial.data_ptr(), adamw.blocks(n), stream)),
            "plain_ms": time_ms(torch, lambda: adamw.sum_squares_plain(
                [gr])),
            "library_ms": min(lib_ms.values()), "library_ms_each": lib_ms,
            "bound_ms": s_bound, "bound_by": s_by, "bytes": s_bytes}
        for name, t in (("adamw_update", update), ("sum_squares", sumsq)):
            t = {"leaf": label, "shape": list(shape),
                 "dtypes": [p_name, g_name], **t,
                 "share_of_bound": t["bound_ms"] / t["ms"],
                 "kernel_share_of_bound": t["bound_ms"] / t["kernel_ms"]}
            log({"time": name, **t})
            rows[name].append(t)
        del p, gr, m, v, flat, partial, scalars, total, again
        torch.cuda.empty_cache()
    return {k: {**r[0], "leaves": r} for k, r in rows.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log({"device": kind, "torch": torch.__version__,
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
    timing["prefetch_pipeline"] = check_prefetch(torch, np, dev, rng)
    timing["paged_attention"] = check_paged(torch, np, dev, rng)
    timing.update(check_moe(torch, np, dev, rng))
    timing["flash_attention"] = check_flash(torch, np, dev, rng)
    tables = {p: {} for p in ("main", "k_sweep", "m_sharded",
                              "n_sharded_serve")}
    with recording_tables(np, tables["main"]):
        by_path = {"main": main_path(torch, np, dev, rng)}
    torch.cuda.empty_cache()                  # the pools of phase 3 are gone
    t0 = time.perf_counter()
    with recording_tables(np, tables["k_sweep"]):
        by_path["k_sweep"], shapes = sweep_path(torch, np, dev, smi)
    check_sweep_drains(torch, np, dev, shapes)
    time_sweep_copies(torch, np, dev, shapes)
    log({"phase": "k", "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    by_path["j_prefill"], by_path["j_decode"] = prefill_path(
        torch, np, dev, rng, args.seed)
    torch.cuda.empty_cache()                  # (j)'s weights are gone
    t0 = time.perf_counter()
    by_path["l_serve"], params = serve_path(torch, np, dev, rng, args.seed)
    log({"phase": "l", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    with recording_tables(np, tables["m_sharded"]):
        by_path["m_sharded"] = sharded_path(torch, np, dev, rng, smi)
    log({"phase": "m", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    with recording_tables(np, tables["n_sharded_serve"]):
        by_path["n_sharded_serve"] = sharded_serve_path(torch, np, dev, rng,
                                                        params)
    log({"phase": "n", "seconds": time.perf_counter() - t0})
    del params
    torch.cuda.empty_cache()                  # (l)'s weights are gone
    t0 = time.perf_counter()
    by_path["o_families"], flash_shapes = family_path(torch, np, dev, rng,
                                                      args.seed)
    log({"phase": "o", "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    timing["flash_attention_bwd"] = check_flash_backward(torch, np, dev, rng)
    by_path["p_train"] = train_path(torch, np, dev, rng, args.seed)
    trainer_path(torch, np, dev, args.seed)
    log({"phase": "p", "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    timing.update(check_moe_backward(torch, np, dev, rng))
    by_path["q_train_families"] = train_family_path(torch, np, dev, rng,
                                                    args.seed)
    log({"phase": "q", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    roofline_path(torch, dev, smi)
    log({"phase": "r", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    by_path["s_collective"] = collective_path(torch, np, smi, args.seed)
    log({"phase": "s", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    by_path["t_flash_domain"], t_shapes, t_flash = domain_path(
        torch, np, dev, rng, args.seed, smi)
    log({"phase": "t", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    timing.update(check_adamw(torch, np, dev, rng))
    log({"phase": "u", "seconds": time.perf_counter() - t0})
    from repro_torch.kernels.descriptor_copy import MAX_TABLE
    log({"largest_descriptors_per_call": tables, "max_table": MAX_TABLE,
         "paths_cut_into_several_launches": sorted(
             p for p, t in tables.items()
             if any(n > MAX_TABLE for n in t.values()))})
    launches = {k: sum(p.get(k, 0) for p in by_path.values())
                for k in build.LAUNCHES}

    csrc = "src/repro_torch/kernels/csrc/"
    # name: (launch counter, source, TPU kernel it replaces)
    src = {"descriptor_copy": ("descriptor_copy", "descriptor_copy",
                               "src/repro/kernels/descriptor_copy.py:39"),
           "quantize_copy": ("quantize_copy", "quantize_copy",
                             "src/repro/kernels/quantize_copy.py:52"),
           "prefetched_chain_copy": ("prefetch_pipeline", "prefetch_pipeline",
                                     "src/repro/kernels/prefetch_pipeline.py:61"),
           "paged_attention": ("paged_attention", "paged_attention",
                               "src/repro/kernels/paged_attention.py:69"),
           "moe_gather": ("moe_gather", "moe_dispatch",
                          "src/repro/kernels/moe_dispatch.py:26"),
           "moe_combine": ("moe_combine", "moe_dispatch",
                           "src/repro/kernels/moe_dispatch.py:57"),
           "flash_attention": ("flash_attention", "flash_attention",
                               "src/repro/kernels/flash_attention.py:78"),
           "flash_attention_bwd": ("flash_attention_bwd",
                                   "flash_attention_bwd",
                                   "src/repro/kernels/flash_attention.py:78"),
           "moe_gather_bwd": ("moe_gather_bwd", "moe_dispatch",
                              "src/repro/kernels/moe_dispatch.py:26"),
           "moe_combine_bwd": ("moe_combine_bwd", "moe_dispatch",
                               "src/repro/kernels/moe_dispatch.py:57"),
           "adamw_update": ("adamw_update", "adamw",
                            "none: src/repro/optim/optimizer.py:64 apply, "
                            "a tree map of plain jnp"),
           "sum_squares": ("sum_squares", "adamw",
                           "none: src/repro/optim/optimizer.py:59 "
                           "global_norm, plain jnp")}
    kernels = []
    for name, (counter, lib, replaces) in src.items():
        t = timing[counter]
        extra = {}
        if name == "flash_attention":
            extra = {"launches_by_shape_o_families": flash_shapes,
                     "launches_by_shape_t": t_shapes,
                     "t_max_abs_err": t_flash["max_abs_err"]["forward"],
                     "shapes": t["shapes"],
                     "shapes_t": [r for r in t_flash["timed"]
                                  if r["part"] == "forward"]}
        elif name == "flash_attention_bwd":
            extra = {"derivative_of": "the forward's attention, which the "
                     "reference differentiates through "
                     "src/repro/models/attention.py:78 blockwise_attention",
                     "t_max_abs_err": t_flash["max_abs_err"]["backward"],
                     "shapes": t["shapes"],
                     "shapes_t": [r for r in t_flash["timed"]
                                  if r["part"] == "backward"]}
        elif name == "moe_gather_bwd":
            extra = {"derivative_of": "moe_gather, which the reference's "
                     "training path differentiates as jnp indexing "
                     "(src/repro/models/moe.py:233)"}
        elif name == "moe_combine_bwd":
            extra = {"derivative_of": "moe_combine, which the reference's "
                     "training path differentiates as jnp indexing and an "
                     "einsum (src/repro/models/moe.py:249)"}
        elif name in ADAMW_KERNELS:
            extra = {"leaves": t["leaves"]}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}{lib}.cu",
                        "replaces": replaces, "launches": launches[counter],
                        "launches_by_path": {p: c.get(counter, 0)
                                             for p, c in by_path.items()},
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "kernel_ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], **extra})
    log(smi)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
