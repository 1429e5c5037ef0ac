"""The expert gather and combine kernels' share of their roofline in the
traced steps, forward and backward: the least time their calls need
(bytes over HBM's rate, or the combine's fp32 operations over the
CUDA-core peak) over their device time. The gather's backward runs the
combine kernel at unit weights: it is counted as many times as the
combine's backward, and the rest of the combine kernel's launches as
combines. Read only where no token can be dropped (capacity factor at
least experts / top_k), where every copy is kept."""
from portbench.counts import kernels, peaks


def read(run):
    t, moe = run.trace, run.arch.get("moe")
    if run.kind != "train" or t is None or not moe \
            or moe["capacity_factor"] * moe["experts_per_token"] \
            < moe["num_experts"]:
        return None
    ks = t.kernels()
    gather = [o for o in ks if "moe_gather_kernel" in o.name]
    combine = [o for o in ks if "moe_combine_kernel" in o.name]
    combine_bwd = [o for o in ks if "moe_combine_bwd_kernel" in o.name]
    if not gather or not combine_bwd or len(combine) < len(combine_bwd):
        return None
    mix = run.mix
    tok = mix["rows"] // mix["microbatches"] * mix["seq_len"]
    k, e = moe["experts_per_token"], moe["num_experts"]
    c = int(tok * k * moe["capacity_factor"] // e)
    slots = e * max(8, (c + 7) // 8 * 8)
    args = (tok, k, slots, run.arch["d_model"], 2)
    bound = 0.0
    for n, fn in ((len(gather), kernels.moe_gather),
                  (len(combine) - len(combine_bwd), kernels.moe_combine),
                  (len(combine_bwd), kernels.moe_gather_bwd),
                  (len(combine_bwd), kernels.moe_combine_bwd)):
        n_bytes, n_ops = fn(*args)
        bound += n * peaks.bound_s(n_bytes, n_ops, peaks.FP32_FLOPS)
    return 100.0 * bound / (sum(o.dur for o in gather + combine
                                + combine_bwd) / 1e6)
