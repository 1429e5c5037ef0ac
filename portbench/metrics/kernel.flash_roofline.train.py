"""Flash attention's share of its roofline in the traced steps: the
least time its calls need (per call the larger of operations over the
bf16 peak and bytes over HBM's rate, from the cell's shapes, the value
head dim ``v_head_dim`` where the architecture has one; forward
calls counted by the forward kernel's launches, backward calls by the
dK/dV kernel's) over the device time of every flash kernel."""
from portbench.counts import kernels, peaks

#: The backward's kernels by name (the tensor-core and CUDA-core designs).
BWD = ("dkdv_mla_kernel", "dkdv_tc_kernel", "dq_tc_kernel",
       "dkdv_256_kernel", "dq_256_kernel", "dkdv_narrow_kernel",
       "dq_narrow_kernel", "lse_kernel", "dkdv_kernel", "dq_kernel",
       "delta_kernel")


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    fwd = [o for o in t.kernels() if "flash_attention" in o.name]
    bwd = [o for o in t.kernels() if any(k in o.name for k in BWD)]
    n_bwd = sum("dkdv" in o.name for o in bwd)
    if not fwd or not n_bwd:
        return None
    a, mix = run.arch, run.mix
    shape = (mix["rows"] // mix["microbatches"], mix["seq_len"],
             a["num_heads"], a["num_kv_heads"], a["head_dim"],
             a.get("v_head_dim", a["head_dim"]), 2)
    bound = 0.0
    for n, work in ((len(fwd), kernels.flash_forward(*shape)),
                    (n_bwd, kernels.flash_backward(*shape))):
        bound += n * peaks.bound_s(work[0], work[1], peaks.BF16_FLOPS)
    return 100.0 * bound / (sum(o.dur for o in fwd + bwd) / 1e6)
