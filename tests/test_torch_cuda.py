"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU: a
CUDA kernel has no CPU mode. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The copies and the MoE gather and combine must be bit-identical to their
plain versions, and so must the gather's backward and the combine's
expert-row gradient (its weight gradient within 1e-5 of its largest
entry), and AdamW's update; the attention kernels agree within rtol =
atol = 2e-5 in float32 and 2e-2 in bfloat16 (the sums run in another
order), and the sum of squares within a relative 1e-5 of a float64 sum
(fp32 sums in a tree over up to 1.1 B elements).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import optim  # noqa: E402
from repro_torch.kernels import adamw, build  # noqa: E402
from repro_torch.kernels.descriptor_copy import (  # noqa: E402
    descriptor_copy,
    descriptor_copy_bucketed,
    descriptor_copy_plain,
)
from repro_torch.kernels.quantize_copy import (  # noqa: E402
    quantize_copy_bucketed,
    quantize_copy_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=g) * 50
    return x.to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,unit,offset", [
    (torch.float32, 4096, 0),      # 16-byte vector path
    (torch.bfloat16, 4096, 0),
    (torch.int32, 3, 0),           # 12-byte rows: 4-byte words
    (torch.int32, 4, 1),           # misaligned base pointer: 4-byte words
    (torch.uint8, 7, 0),           # 7-byte rows: the byte path
])
def test_cuda_descriptor_copy_matches_plain(cuda, dtype, unit, offset):
    flat_s = _rows((64 * unit + offset,), dtype, cuda, 0)
    flat_d = _rows((64 * unit + offset,), dtype, cuda, 1)
    src = flat_s[offset:].view(64, unit)
    dst = flat_d[offset:].view(64, unit)
    sidx = np.array([3, -1, 7, 0, 9, 2, 5, 5], np.int64)
    didx = np.array([0, 4, 9, 63, 9, 6, -1, 1], np.int64)
    want = descriptor_copy_plain(sidx, didx, src, dst.clone())
    before = build.launch_counts()["descriptor_copy"]
    got = descriptor_copy_bucketed(sidx, didx, src, dst, n_bucket=16)
    torch.cuda.synchronize()
    assert build.launch_counts()["descriptor_copy"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_descriptor_copy_aliased_move_chain(cuda):
    pool = _rows((256, 1024), torch.float32, cuda, 2)
    sidx, didx = np.arange(0, 128), np.arange(64, 192)   # overlapping rows
    # Every descriptor reads the pool as it was before the call.
    want = descriptor_copy_plain(sidx, didx, pool.clone(), pool.clone())
    got = descriptor_copy(sidx, didx, pool, pool)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantize_copy_matches_plain(cuda, dtype):
    src = (_rows((32, 1024), torch.float32, cuda, 3) / 10).to(dtype)
    src[1, :256] = 0                                  # scale floor
    src[2, :256] = torch.arange(256, device=cuda) % 254 - 126.5
    src[2, 0] = 127.0                    # scale exactly 1: exact .5 ties
    dst = _rows((32, 1024), dtype, cuda, 4)
    sidx, didx = np.arange(0, 16), np.arange(16, 32)[::-1].copy()
    want = quantize_copy_plain(sidx, didx, src, dst.clone())
    got = quantize_copy_bucketed(sidx, didx, src, dst, n_bucket=32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,unit,offset", [
    (torch.float32, 4096, 0),      # cp.async 16-byte path
    (torch.bfloat16, 4096, 0),
    (torch.int32, 3, 0),           # 12-byte rows: cp.async 4-byte path
    (torch.int32, 4, 1),           # misaligned base pointer: 4-byte path
    (torch.uint8, 7, 0),           # 7-byte rows: the byte path
])
@pytest.mark.parametrize("depth", [2, 4, 8])
def test_cuda_prefetched_chain_copy_matches_plain(cuda, dtype, unit, offset,
                                                  depth):
    from repro_torch.kernels.prefetch_pipeline import (
        prefetched_chain_copy, prefetched_chain_copy_plain)
    flat_s = _rows((64 * unit + offset,), dtype, cuda, 5)
    flat_d = _rows((64 * unit + offset,), dtype, cuda, 6)
    src = flat_s[offset:].view(64, unit)
    dst = flat_d[offset:].view(64, unit)
    sidx = np.array([3, -1, 7, 0, 9, 2, 5, 5, 11, 12, 13], np.int64)
    didx = np.array([0, 4, 9, 63, 9, 6, -1, 1, 40, 41, 42], np.int64)
    want = prefetched_chain_copy_plain(sidx, didx, src, dst.clone())
    before = build.launch_counts()["prefetch_pipeline"]
    got = prefetched_chain_copy(sidx, didx, src, dst, depth=depth)
    torch.cuda.synchronize()
    assert build.launch_counts()["prefetch_pipeline"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 40])
def test_cuda_prefetched_chain_copy_short_and_aliased(cuda, n):
    from repro_torch.kernels.prefetch_pipeline import (
        prefetched_chain_copy, prefetched_chain_copy_plain)
    pool = _rows((128, 1024), torch.float32, cuda, 7)
    sidx, didx = np.arange(0, n), np.arange(n // 2, n // 2 + n)  # overlap
    want = prefetched_chain_copy_plain(sidx, didx, pool.clone(),
                                       pool.clone())
    got = prefetched_chain_copy(sidx, didx, pool, pool, depth=4)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The copies' descriptor tables: capacities, the bulk-copy path, aliasing,
# clamping and errors on the by-value route
# ---------------------------------------------------------------------------

def _copy_kernels():
    from repro_torch.kernels.prefetch_pipeline import (
        prefetched_chain_copy, prefetched_chain_copy_plain)
    return {"descriptor_copy": ("descriptor_copy", descriptor_copy,
                                descriptor_copy_plain, False),
            "prefetched_chain_copy": ("prefetch_pipeline",
                                      lambda *a: prefetched_chain_copy(
                                          *a, depth=4),
                                      prefetched_chain_copy_plain, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 128, 129, 512, 513, 4088, 4089, 9000])
@pytest.mark.parametrize("unit", [64, 1024])       # 256 B rows; 4 KiB: bulk
@pytest.mark.parametrize("kernel", ["descriptor_copy",
                                    "prefetched_chain_copy"])
def test_cuda_copies_across_table_capacities(cuda, kernel, unit, n):
    """n at each table's capacity (128, 512, 4,088) and one above, and far
    above the largest: destinations repeat across blocks and launches
    (the last write wins), -1 on both sides; the launches are those of the
    host pass's plain model, so n <= 4,088 active is exactly one."""
    from repro_torch.kernels.ref import table_launches
    counter, fn, plain, clamp = _copy_kernels()[kernel]
    rng = np.random.default_rng(n + unit)
    src = _rows((9000, unit), torch.float32, cuda, 20)
    dst = _rows((9000, unit), torch.float32, cuda, 21)
    sidx = rng.integers(-1, 9000, n)
    didx = rng.integers(-1, 2000, n)
    want = plain(sidx, didx, src, dst.clone())
    before = build.launch_counts()[counter]
    got = fn(sidx, didx, src, dst)
    torch.cuda.synchronize()
    launches = build.launch_counts()[counter] - before
    assert launches == len(table_launches(sidx, didx, clamp=clamp))
    if 0 < n <= 4088:
        assert launches == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset_bytes", [0, 16])  # 16-byte aligned bases
@pytest.mark.parametrize("row_kib", [4, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["descriptor_copy",
                                    "prefetched_chain_copy"])
def test_cuda_copies_wide_rows(cuda, kernel, dtype, row_kib, offset_bytes):
    """Rows of 4 and 64 KiB, 16-byte aligned in width and base (the bulk
    copy path of descriptor_copy), also with both pools starting 16 bytes
    into their storage."""
    counter, fn, plain, _ = _copy_kernels()[kernel]
    esize = torch.tensor([], dtype=dtype).element_size()
    unit, off, rows = row_kib * 1024 // esize, offset_bytes // esize, 96
    src = _rows((rows * unit + off,), dtype, cuda, 22)[off:].view(rows, unit)
    dst = _rows((rows * unit + off,), dtype, cuda, 23)[off:].view(rows, unit)
    rng = np.random.default_rng(row_kib + offset_bytes)
    sidx = rng.integers(0, rows, 80)
    didx = rng.integers(0, 48, 80)
    sidx[::9] = -1
    want = plain(sidx, didx, src, dst.clone())
    before = build.launch_counts()[counter]
    got = fn(sidx, didx, src, dst)
    torch.cuda.synchronize()
    assert build.launch_counts()[counter] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [64, 1024])
@pytest.mark.parametrize("kernel", ["descriptor_copy",
                                    "prefetched_chain_copy"])
def test_cuda_copies_aliased_across_launches(cuda, kernel, unit):
    """src is dst and the chain is longer than the largest table: every
    launch reads the pool as it was before the call."""
    counter, fn, plain, _ = _copy_kernels()[kernel]
    pool = _rows((12000, unit), torch.float32, cuda, 24)
    sidx, didx = np.arange(0, 9000), np.arange(3000, 12000)  # overlapping
    want = plain(sidx, didx, pool.clone(), pool.clone())
    got = fn(sidx, didx, pool, pool)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_prefetched_chain_copy_clamps_negative_indices_to_row_zero(
        cuda):
    from repro_torch.kernels.prefetch_pipeline import (
        prefetched_chain_copy, prefetched_chain_copy_plain)
    src = _rows((16, 1024), torch.float32, cuda, 25)
    dst = _rows((16, 1024), torch.float32, cuda, 26)
    sidx = np.array([3, -1, 7, 5, -7, 2])
    didx = np.array([4, 6, -1, 8, 11, -3])
    want = prefetched_chain_copy_plain(sidx, didx, src, dst.clone())
    got = prefetched_chain_copy(sidx, didx, src, dst.clone(), depth=3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[6], src[0]) and torch.equal(got[11], src[0])
    assert torch.equal(got[0], src[2])          # the last write to row 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["descriptor_copy",
                                    "prefetched_chain_copy"])
def test_cuda_copies_raise_out_of_range_before_writing(cuda, kernel):
    counter, fn, _, _ = _copy_kernels()[kernel]
    src = _rows((16, 64), torch.float32, cuda, 27)
    dst = torch.zeros((16, 64), device=cuda)
    late = np.zeros(5001, np.int64)
    late[-1] = 16            # out of range after the first table's worth
    before = build.launch_counts()[counter]
    for sidx, didx in ((np.array([0, 16]), np.array([1, 2])),
                       (np.array([0, 1]), np.array([1, 16])),
                       (late, np.arange(5001) % 16)):
        with pytest.raises(IndexError, match="out of range"):
            fn(sidx, didx, src, dst)
    torch.cuda.synchronize()
    assert not dst.any()
    assert build.launch_counts()[counter] == before


@pytest.mark.cuda
def test_cuda_descriptor_copy_bucketed_raises_above_the_bucket(cuda):
    src = _rows((16, 64), torch.float32, cuda, 28)
    dst = torch.zeros((16, 64), device=cuda)
    with pytest.raises(ValueError, match="exceed bucket"):
        descriptor_copy_bucketed(np.arange(5), np.arange(5), src, dst,
                                 n_bucket=4)
    before = build.launch_counts()["descriptor_copy"]
    descriptor_copy_bucketed(np.arange(4), np.arange(4), src, dst,
                             n_bucket=4)
    torch.cuda.synchronize()
    assert build.launch_counts()["descriptor_copy"] == before + 1
    assert torch.equal(dst[:4], src[:4]) and not dst[4:].any()


def _paged_inputs(device, dtype, b, h, kv, d, page, pool, maxp, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g).to(dtype).to(device)
    kp = torch.randn((pool, page, kv, d), generator=g).to(dtype).to(device)
    vp = torch.randn((pool, page, kv, d), generator=g).to(dtype).to(device)
    tables = torch.randperm(pool, generator=g)[:b * maxp].view(b, maxp)
    lengths = torch.randint(0, maxp * page + 1, (b,), generator=g)
    lengths[0], lengths[1] = 0, maxp * page - 3    # empty; partial page
    pos = torch.arange(maxp)[None, :] * page
    tables = torch.where(pos < lengths[:, None], tables, -1)
    tables[1, 1] = -1                              # a hole inside the length
    return (q, kp, vp, tables.to(torch.int32).to(device),
            lengths.to(torch.int32).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kv,d", [(40, 8, 128), (8, 8, 128), (6, 2, 256),
                                    (5, 1, 64)])
def test_cuda_paged_attention_matches_plain(cuda, dtype, tol, h, kv, d):
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)
    args = _paged_inputs(cuda, dtype, 6, h, kv, d, 16, 64, 8, 11)
    want = paged_attention_plain(*args)
    before = build.launch_counts()["paged_attention"]
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert build.launch_counts()["paged_attention"] == before + 1
    assert not got[0].float().any()                # length 0: zeros
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_cuda_paged_attention_is_deterministic_wherever_pages_sit(cuda):
    from repro_torch.kernels.paged_attention import paged_attention
    q, kp, vp, tables, lengths = _paged_inputs(cuda, torch.float32, 8, 40,
                                               8, 128, 16, 96, 8, 12)
    a = paged_attention(q, kp, vp, tables, lengths)
    b = paged_attention(q, kp, vp, tables, lengths)
    # Move every page to another slot: the logical KV is the same.
    perm = torch.randperm(96, device=cuda)
    kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
    kp2[perm], vp2[perm] = kp, vp
    moved = torch.where(tables >= 0, perm[tables.long().clamp_min(0)],
                        -1).to(torch.int32)
    c = paged_attention(q, kp2, vp2, moved, lengths)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)


# ---------------------------------------------------------------------------
# moe_gather, moe_combine (bit-identical) and flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,idx_kind", [
    (torch.bfloat16, 6144, "mixed"),   # 16-byte vectors
    (torch.float32, 256, "mixed"),
    (torch.bfloat16, 100, "mixed"),    # 200-byte rows: 4-byte words
    (torch.bfloat16, 7, "mixed"),      # 14-byte rows: bytes
    (torch.float32, 512, "all -1"),
    (torch.bfloat16, 512, "no -1"),
])
def test_cuda_moe_gather_matches_plain(cuda, dtype, d, idx_kind):
    from repro_torch.kernels.moe_dispatch import moe_gather, moe_gather_plain
    tokens = _rows((96, d), dtype, cuda, 20)
    g = torch.Generator(device="cpu").manual_seed(21)
    idx = torch.randint(-1, 96, (160,), generator=g, dtype=torch.int32)
    if idx_kind == "all -1":
        idx[:] = -1
    elif idx_kind == "no -1":
        idx = idx.clamp_min(0)
    idx = idx.to(cuda)
    want = moe_gather_plain(idx, tokens)
    before = build.launch_counts()["moe_gather"]
    got = moe_gather(idx, tokens)
    torch.cuda.synchronize()
    assert build.launch_counts()["moe_gather"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 6144),
                                     (torch.float32, 512),
                                     (torch.bfloat16, 100),   # unaligned path
                                     (torch.float32, 37)])
@pytest.mark.parametrize("k", [1, 4, 6])
def test_cuda_moe_combine_matches_plain(cuda, dtype, d, k):
    from repro_torch.kernels.moe_dispatch import (moe_combine,
                                                  moe_combine_plain)
    eo = _rows((128, d), dtype, cuda, 22)
    eo[0] = float("nan")              # read by no kept copy
    g = torch.Generator(device="cpu").manual_seed(23)
    slot = torch.randint(1, 128, (64, k), generator=g, dtype=torch.int32)
    slot[torch.rand((64, k), generator=g) < 0.3] = -1
    slot[5] = -1                      # a token with every copy dropped
    w = torch.rand((64, k), generator=g)
    slot, w = slot.to(cuda), w.to(cuda)
    want = moe_combine_plain(slot, w, eo)
    before = build.launch_counts()["moe_combine"]
    got = moe_combine(slot, w, eo)
    torch.cuda.synchronize()
    assert build.launch_counts()["moe_combine"] == before + 1
    assert torch.equal(got, want)
    assert torch.isfinite(got.float()).all() and not got[5].float().any()


def _dual_plan(t, k, rows, seed, drop=0.3):
    """(token_idx, inv_slot, inv_weight) of a random plan that keeps the
    dispatch plan's duality: each kept copy has a slot of its own among
    ``rows``, ``token_idx`` names the slot's token, the other slots are
    empty (-1); some copies dropped, token 5 with all of its."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    slot = torch.randperm(rows, generator=g)[:t * k].view(t, k).int()
    slot[torch.rand((t, k), generator=g) < drop] = -1
    slot[5] = -1
    kept = slot >= 0
    token_idx = torch.full((rows,), -1, dtype=torch.int32)
    token_idx[slot[kept].long()] = torch.arange(t, dtype=torch.int32)[
        :, None].expand(t, k)[kept]
    w = torch.where(kept, torch.rand((t, k), generator=g), 0.0)
    return token_idx, slot, w


def _dbrx_plan(cuda, seed):
    """A dispatch plan at dbrx-132b's training shape: 2,048 tokens, 16
    experts top-4, capacity 640, a skewed router (drops and empty slots)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity, moe_dispatch_plan
    m = get_config("dbrx-132b").moe
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = torch.randn((2048, m.num_experts), generator=g) \
        + torch.linspace(-1.5, 1.5, m.num_experts)
    plan = moe_dispatch_plan(torch.softmax(logits, -1).to(cuda), m,
                             capacity(2048, m))
    return plan.token_idx, plan.inv_slot, plan.inv_weight


MOE_BWD_CASES = [  # dtype, T, k, rows, d
    (torch.bfloat16, 64, 4, 400, 6144),   # 16-byte chunks
    (torch.float32, 64, 6, 512, 512),
    (torch.bfloat16, 64, 1, 128, 256),    # k 1
    (torch.bfloat16, 64, 2, 200, 100),    # d not a multiple of 8
    (torch.float32, 48, 10, 600, 37),     # k over 8: two passes of copies
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,k,rows,d", MOE_BWD_CASES + [("dbrx", 2048, 4, 10240, 6144)])
def test_cuda_moe_gather_backward_matches_plain(cuda, dtype, t, k, rows, d):
    """d_tokens bit-identical to the plain backward and across launches."""
    from repro_torch.kernels.moe_dispatch import (
        moe_gather_backward, moe_gather_backward_plain)
    if dtype == "dbrx":
        dtype = torch.bfloat16
        _, slot, _ = _dbrx_plan(cuda, 30)
    else:
        _, slot, _ = _dual_plan(t, k, rows, 30 + k)
    slot = slot.to(cuda)
    d_slots = _rows((rows, d), dtype, cuda, 31)
    want = moe_gather_backward_plain(slot, d_slots)
    before = build.launch_counts()["moe_gather_bwd"]
    got = moe_gather_backward(slot, d_slots)
    again = moe_gather_backward(slot, d_slots)
    torch.cuda.synchronize()
    assert build.launch_counts()["moe_gather_bwd"] == before + 2
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got, again)
    assert not got[(slot < 0).all(1)].float().any()   # every copy dropped


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,k,rows,d", MOE_BWD_CASES + [("dbrx", 2048, 4, 10240, 6144)])
def test_cuda_moe_combine_backward_matches_plain(cuda, dtype, t, k, rows, d):
    """d_expert_out bit-identical to the plain backward (zeros in the empty
    slots, which the kernel writes), d_inv_weight within 1e-5 of its
    largest entry (0 for a dropped copy); both bit-identical across
    launches."""
    from repro_torch.kernels.moe_dispatch import (
        moe_combine_backward, moe_combine_backward_plain)
    if dtype == "dbrx":
        dtype = torch.bfloat16
        token_idx, slot, w = _dbrx_plan(cuda, 32)
    else:
        token_idx, slot, w = _dual_plan(t, k, rows, 32 + k)
    token_idx, slot, w = token_idx.to(cuda), slot.to(cuda), w.to(cuda)
    eo = _rows((rows, d), dtype, cuda, 33)
    dy = _rows((slot.shape[0], d), dtype, cuda, 34)
    want_eo, want_w = moe_combine_backward_plain(slot, w, eo, dy)
    before = build.launch_counts()["moe_combine_bwd"]
    got_eo, got_w = moe_combine_backward(slot, w, eo, dy, token_idx=token_idx)
    again_eo, again_w = moe_combine_backward(slot, w, eo, dy,
                                             token_idx=token_idx)
    torch.cuda.synchronize()
    assert build.launch_counts()["moe_combine_bwd"] == before + 2
    assert got_eo.dtype == dtype and torch.equal(got_eo, want_eo)
    assert torch.equal(got_eo, again_eo) and torch.equal(got_w, again_w)
    err = float((got_w - want_w).abs().max())
    assert err <= 1e-5 * float(want_w.abs().max()), err
    assert not got_w[slot < 0].any()
    assert not got_eo[token_idx < 0].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_moe_functions_match_plain_autograd(cuda, dtype, tol):
    """``moe_gather``/``moe_combine`` under autograd on the card (forward
    and backward kernels) against autograd of the plain forwards, within
    ``tol`` of each gradient's largest entry (autograd's scatter-add sums
    in bf16 and in another order)."""
    from repro_torch.kernels.moe_dispatch import (
        moe_combine, moe_combine_plain, moe_gather, moe_gather_plain)
    token_idx, slot, w = (x.to(cuda) for x in _dual_plan(64, 4, 320, 35))
    tokens = _rows((64, 512), dtype, cuda, 36) / 50
    eo = _rows((320, 512), dtype, cuda, 37) / 50
    g = torch.Generator(device="cpu").manual_seed(38)
    dg = torch.randn((320, 512), generator=g).to(dtype).to(cuda)
    dc = torch.randn((64, 512), generator=g).to(dtype).to(cuda)
    ours = [x.clone().requires_grad_() for x in (tokens, eo, w)]
    plain = [x.clone().requires_grad_() for x in (tokens, eo, w)]
    before = dict(build.launch_counts())
    outs = (moe_gather(token_idx, ours[0], inv_slot=slot),
            moe_combine(slot, ours[2], ours[1], token_idx=token_idx))
    torch.autograd.backward(outs, (dg, dc))
    torch.cuda.synchronize()
    after = build.launch_counts()
    for name in ("moe_gather", "moe_combine", "moe_gather_bwd",
                 "moe_combine_bwd"):
        assert after[name] == before[name] + 1, name
    torch.autograd.backward(
        (moe_gather_plain(token_idx, plain[0]),
         moe_combine_plain(slot, plain[2], plain[1])), (dg, dc))
    for x, y in zip(ours, plain):
        err = float((x.grad.float() - y.grad.float()).abs().max())
        assert err <= tol * float(y.grad.float().abs().max()), err


@pytest.mark.cuda
def test_cuda_moe_ffn_grads_match_plain_ops(cuda):
    """The reduced dbrx-132b's MoE layer under autograd on the card, through
    the four MoE kernels, against the same layer on the plain ops (the same
    routing: fp32, and the router's top-k margin checked)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_dispatch import (moe_combine_plain,
                                                  moe_gather_plain)
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True),
                              compute_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(39)
    params = moe.init_moe(gen, cfg, cuda)
    x = torch.randn((2, 64, cfg.d_model), device=cuda, generator=gen)
    dy = torch.randn(x.shape, device=cuda, generator=gen)

    def grads():
        leaves = [x] + [params[k] for k in sorted(params)]
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        p = dict(zip(sorted(params), leaves[1:]))
        y, aux, _ = moe.moe_ffn(p, leaves[0], cfg)
        return torch.autograd.grad((y * dy).sum() + aux, leaves)

    before = dict(build.launch_counts())
    got = grads()
    after = build.launch_counts()
    for name in ("moe_gather", "moe_combine", "moe_gather_bwd",
                 "moe_combine_bwd"):
        assert after[name] == before[name] + 1, name
    with mock.patch.object(ops, "moe_gather_op",
                           lambda i, t, inv_slot=None: moe_gather_plain(i, t)), \
            mock.patch.object(ops, "moe_combine_op",
                              lambda s, w, e, token_idx=None:
                              moe_combine_plain(s, w, e)):
        want = grads()
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()) + 1e-12, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window,q_scale", [
    (1, 2048, 48, 8, 128, True, None, 1),
    (2, 200, 8, 8, 64, False, None, 1),
    (2, 200, 48, 8, 128, True, 64, 1),
    (1, 300, 8, 8, 64, False, 64, 1),
    (3, 65, 4, 2, 128, True, None, 1),
    (2, 1000, 48, 8, 128, True, None, 1),   # S not a multiple of 128, G 6
    (1, 777, 8, 8, 64, True, 100, 1),       # a window across tile edges
    (2, (64, 300), 8, 2, 128, False, None, 1),  # Sq != Sk
    (1, (64, 0), 8, 2, 64, False, None, 1),     # no keys: zeros
    (2, 333, 16, 4, 128, True, None, 8),    # large logits: online rescale
    (4, 512, 16, 2, 128, True, None, 1),    # qwen2.5-3b's prefill: G 8
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, tol, b, s, h, kv, d,
                                            causal, window, q_scale):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    sq, sk = s if isinstance(s, tuple) else (s, s)
    g = torch.Generator(device="cpu").manual_seed(sq + h)
    q = (torch.randn((b, sq, h, d), generator=g) * q_scale).to(dtype).to(cuda)
    k = torch.randn((b, sk, kv, d), generator=g).to(dtype).to(cuda)
    v = torch.randn((b, sk, kv, d), generator=g).to(dtype).to(cuda)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    before = build.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,d,dv,causal,window", [
    (2, 1024, 32, 32, 96, 96, True, None),     # phi-3-vision's prefill
    (2, 300, 8, 8, 96, 96, False, None),
    (1, 777, 8, 4, 96, 96, True, 100),
    (2, (64, 300), 8, 8, 96, 96, False, None),
    # The 96 tiles' edges: S not a multiple of 64 or 128, Sq != Sk both
    # ways, a window across tile edges, G 4, rows with no visible key
    # (from 95 on: the window ends before them).
    (1, 97, 4, 4, 96, 96, True, None),
    (2, 333, 8, 8, 96, 96, True, None),
    (1, (300, 64), 8, 8, 96, 96, True, None),
    (1, (97, 333), 4, 4, 96, 96, True, None),
    (2, 333, 8, 8, 96, 96, True, 64),
    (1, 333, 32, 8, 96, 96, True, None),
    (1, (300, 64), 8, 8, 96, 96, True, 32),
    (1, 512, 128, 128, 192, 128, True, None),  # deepseek-v2's MLA prefill
    (2, 333, 16, 16, 192, 128, True, None),    # 3 query tiles of 128
    (1, 640, 16, 16, 192, 128, True, None),    # 5 query tiles of 128
    (1, 777, 8, 4, 192, 128, True, 100),       # GQA, a window, 7 tiles
    (2, 200, 8, 8, 192, 128, False, None),
    (1, (64, 300), 8, 8, 192, 128, False, None),
])
def test_cuda_flash_attention_other_head_dims_match_plain(
        cuda, dtype, tol, b, s, h, kv, d, dv, causal, window):
    """Head dim 96 (a box of 64 columns and one of 32 in the tensor-core
    tiles) and
    query/key heads of 192 over value heads of 128 (MLA), against the
    plain version, with the launch counted under its shape."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES_BY_SHAPE, flash_attention, flash_attention_plain, shape_key)
    sq, sk = s if isinstance(s, tuple) else (s, s)
    g = torch.Generator(device="cpu").manual_seed(sq + h + d)
    q = torch.randn((b, sq, h, d), generator=g).to(dtype).to(cuda)
    k = torch.randn((b, sk, kv, d), generator=g).to(dtype).to(cuda)
    v = torch.randn((b, sk, kv, dv), generator=g).to(dtype).to(cuda)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    key = shape_key(d, dv, causal)
    before = (build.launch_counts()["flash_attention"],
              LAUNCHES_BY_SHAPE[key])
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (build.launch_counts()["flash_attention"],
            LAUNCHES_BY_SHAPE[key]) == (before[0] + 1, before[1] + 1)
    assert got.shape == (b, sq, h, dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


#: gemma3-12b's heads of 256 (G 2): B, S or (Sq, Sk), H, KV, causal,
#: window, q scale. The first two are its prefill's global and local
#: layers.
FLASH_256_CASES = [
    (2, 2048, 16, 8, True, None, 1),
    (2, 2048, 16, 8, True, 1024, 1),
    (2, 300, 8, 8, False, None, 1),       # G 1, not causal
    (1, 777, 8, 4, True, 100, 1),         # a window across tile edges
    (2, (64, 300), 4, 2, False, None, 1),  # Sq != Sk
    (1, (64, 0), 4, 2, False, None, 1),   # no keys: zeros
    (2, 333, 4, 2, True, None, 8),        # large logits: online rescale
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,causal,window,q_scale", FLASH_256_CASES)
def test_cuda_flash_attention_head256_matches_plain(
        cuda, dtype, tol, b, s, h, kv, causal, window, q_scale):
    """Head dim 256 (K/V tiles of 64 keys on the tensor cores) against
    the plain version, the launch counted under its shape."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES_BY_SHAPE, flash_attention, flash_attention_plain, shape_key)
    sq, sk = s if isinstance(s, tuple) else (s, s)
    g = torch.Generator(device="cpu").manual_seed(sq + sk + h)
    q = (torch.randn((b, sq, h, 256), generator=g) * q_scale).to(dtype) \
        .to(cuda)
    k = torch.randn((b, sk, kv, 256), generator=g).to(dtype).to(cuda)
    v = torch.randn((b, sk, kv, 256), generator=g).to(dtype).to(cuda)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    key = shape_key(256, 256, causal)
    before = (build.launch_counts()["flash_attention"],
              LAUNCHES_BY_SHAPE[key])
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (build.launch_counts()["flash_attention"],
            LAUNCHES_BY_SHAPE[key]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


#: The reduced configs' head dims (D, DV) with the rest of a case: B, S or
#: (Sq, Sk), H, KV, causal, window. gemma3-12b's reduced window of 16
#: crosses tile edges; G 1 and G > 1; MLA's reduced 24 over 16. The last
#: cases cross the narrow kernels' tiles of 128 queries and keys: S and Sk
#: not multiples of 128 (2,085, 129, 255), Sq != Sk, G 1, 4 and 8,
#: windows of 16 and 100.
FLASH_NARROW_CASES = [
    (16, 16, 2, 200, 8, 2, True, None),     # qwen2.5-3b's reduced heads
    (16, 16, 1, (64, 300), 4, 4, False, None),
    (24, 24, 2, 300, 4, 2, True, 16),       # gemma3-12b's reduced window
    (24, 24, 1, 333, 4, 4, False, None),
    (24, 16, 2, 200, 4, 4, True, None),     # deepseek-v2's reduced MLA
    (24, 16, 1, (64, 150), 4, 4, False, None),
    (32, 32, 2, 257, 8, 4, True, None),     # qwen3-14b's reduced heads
    (32, 32, 1, 300, 4, 4, True, 100),
] + [(d, dv) + rest for (d, dv), rest in (
    ((16, 16), (1, 2085, 8, 1, True, None)),    # G 8 over 17 tiles
    ((16, 16), (2, (129, 255), 4, 4, True, 16)),
    ((24, 24), (1, (255, 129), 8, 2, False, None)),
    ((24, 24), (1, 2085, 4, 1, True, 100)),     # G 4, a window of 100
    ((24, 16), (2, 255, 4, 4, True, 16)),       # G 1, a window of 16
    ((24, 16), (1, (129, 2085), 4, 4, False, 100)),
    ((32, 32), (1, (255, 129), 8, 1, True, None)),
    ((32, 32), (2, 129, 4, 2, True, 100)),
)]
#: Logit softcaps: none, one that barely bites at a random init's scores,
#: one that makes the cap's derivative matter.
SOFTCAPS = [None, 50.0, 5.0]


def _flash_inputs(cuda, dtype, b, s, h, kv, d, dv, seed, q_scale=1):
    sq, sk = s if isinstance(s, tuple) else (s, s)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn((b, sq, h, d), generator=g) * q_scale).to(dtype) \
        .to(cuda)
    k = torch.randn((b, sk, kv, d), generator=g).to(dtype).to(cuda)
    v = torch.randn((b, sk, kv, dv), generator=g).to(dtype).to(cuda)
    return q, k, v


def _hold_flash_forward(cuda, dtype, tol, case, softcap, q_scale=1):
    from repro_torch.kernels.flash_attention import (
        LAUNCHES_BY_SHAPE, flash_attention, flash_attention_plain, shape_key)
    d, dv, b, s, h, kv, causal, window = case
    q, k, v = _flash_inputs(cuda, dtype, b, s, h, kv, d, dv, d + h + b,
                            q_scale)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    key = shape_key(d, dv, causal, softcap)
    before = (build.launch_counts()["flash_attention"],
              LAUNCHES_BY_SHAPE[key])
    got = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap)
    again = flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    torch.cuda.synchronize()
    assert (build.launch_counts()["flash_attention"],
            LAUNCHES_BY_SHAPE[key]) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, again), "two launches differ"
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("softcap", SOFTCAPS)
@pytest.mark.parametrize("case", FLASH_NARROW_CASES)
def test_cuda_flash_attention_narrow_heads_match_plain(cuda, dtype, tol,
                                                       case, softcap):
    """The reduced configs' heads of 16, 24, 24 over 16 and 32 (one box
    that TMA zero-fills past D on the tensor cores; V's columns padded to
    32 on the CUDA cores), with and without a logit softcap, against the
    plain version, two launches bit-identical and counted under its
    shape."""
    _hold_flash_forward(cuda, dtype, tol, case, softcap)


#: The published head dims under a cap: (D, DV), B, S, H, KV, causal,
#: window, q scale (large logits: the cap bounds them).
FLASH_CAP_CASES = [
    ((64, 64, 2, 300, 8, 2, True, None), 1),
    ((96, 96, 1, 333, 8, 8, True, 100), 1),
    ((96, 96, 1, (97, 333), 32, 8, True, 64), 1),
    ((96, 96, 2, (300, 64), 8, 8, True, 32), 8),   # rows without keys
    ((128, 128, 2, 512, 16, 2, True, None), 8),
    ((128, 128, 1, (64, 300), 8, 2, False, None), 1),
    ((256, 256, 1, 777, 8, 4, True, 100), 1),
    ((256, 256, 2, 300, 4, 2, False, None), 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("softcap", [50.0, 5.0])
@pytest.mark.parametrize("case,q_scale", FLASH_CAP_CASES)
def test_cuda_flash_attention_softcap_matches_plain(cuda, dtype, tol, case,
                                                    q_scale, softcap):
    """The logit softcap at the published head dims against the plain
    version: c tanh(s / c) before the mask, the log-sum-exp of the capped
    scores."""
    _hold_flash_forward(cuda, dtype, tol, case, softcap, q_scale)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_a_cap_at_mla_heads(cuda):
    """MLA's (192, 128) takes no softcap (MLA passes none): the wrappers
    raise rather than launch."""
    from repro_torch.kernels.flash_attention import (
        _forward, flash_attention, flash_attention_backward)
    q = torch.zeros((1, 16, 2, 192), device=cuda)
    v = torch.zeros((1, 16, 2, 128), device=cuda)
    before = dict(build.launch_counts())
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, q, v, softcap=5.0)
    out, lse = _forward(q, q, v, True, None, with_lse=True)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention_backward(q, q, v, out, lse, out, softcap=5.0)
    after = build.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"]


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_other_head_dims(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros((1, 16, 2, 80), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 16, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q[..., :64].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["positions", "head dim"])
def test_cuda_attention_raises_rather_than_falling_back(cuda, what):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attention, init_attention
    cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True),
                              head_dim=64)
    if what == "head dim":
        cfg = dataclasses.replace(cfg, head_dim=80)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_attention(gen, cfg, cuda)
    x = torch.randn((1, 32, cfg.d_model), device=cuda).to(cfg.cdtype)
    pos = torch.arange(32, device=cuda, dtype=torch.int32)[None]
    if what == "positions":
        pos = pos + 1
    before = build.launch_counts()["flash_attention"]
    with pytest.raises(NotImplementedError, match=what):
        attention(params, x, pos, cfg)
    assert build.launch_counts()["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 64])
def test_cuda_capped_attention_matches_plain(cuda, head_dim):
    """A config with a logit softcap runs its attention through the flash
    kernel on the card (the reduced head dim of 16 and 64), forward and
    backward, and matches the same layer with the plain flash."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import attention, init_attention
    cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True),
                              head_dim=head_dim, attn_logit_softcap=5.0,
                              compute_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_attention(gen, cfg, cuda)
    x = torch.randn((2, 96, cfg.d_model), device=cuda, requires_grad=True)
    pos = torch.arange(96, device=cuda, dtype=torch.int32)[None] \
        .expand(2, 96)
    before = dict(build.launch_counts())
    got = attention(params, x, pos, cfg)
    (dx,) = torch.autograd.grad(got.square().sum(), x)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    real = ops.flash_attention_op
    ops.flash_attention_op = lambda q, k, v, **kw: \
        flash_attention_plain(q, k, v, causal=kw["causal"],
                              window=kw["window"], softcap=kw["softcap"])
    try:
        want = attention(params, x, pos, cfg)
        (dx_want,) = torch.autograd.grad(want.square().sum(), x)
    finally:
        ops.flash_attention_op = real
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, dx_want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_cuda_sweep_subset_equals_committed_cells(cuda):
    """The port's sweep on the card: the committed BENCH_perf.json cells of
    two configs, metrics and counters exactly, through descriptor_copy."""
    import dataclasses
    import json
    from pathlib import Path

    from repro_torch.perf import gate, sweep

    base = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCH_perf.json").read_text())
    ported, _ = gate.ported_subset(base)
    spec = dataclasses.replace(sweep.spec_from_doc(ported),
                               archs=("deepseek-v2-236b", "qwen3-14b"))
    before = build.launch_counts()["descriptor_copy"]
    doc = sweep.run_sweep(spec, device=cuda)
    assert build.launch_counts()["descriptor_copy"] > before
    assert len(doc["cells"]) == 2 * 8 + 2 + 4 + 1 + 4  # serve, sharded
    for key, cell in doc["cells"].items():
        assert cell == base["cells"][key], key


@pytest.mark.cuda
@pytest.mark.parametrize("arch,workload", [
    ("qwen3-14b", "moe_dispatch"), ("deepseek-v2-236b", "chain_mix"),
    ("seamless-m4t-medium", "paged_kv")])
def test_cuda_sweep_drains_match_the_cpu(cuda, arch, workload):
    """One runtime pass of the sweep's traffic over a random source pool:
    the card's destination pool equals the CPU runtime's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.perf.workloads import QUICK, generate
    from repro_torch.runtime import ChannelConfig, DMARuntime, SubmitRequest

    wl = generate(workload, get_config(arch), QUICK, 0)
    src = _rows((wl.pool_elems,), torch.float32, "cpu", 5)
    out = []
    for dev in ("cpu", cuda):
        rt = DMARuntime([ChannelConfig(name=f"ch{i}", tier="serial",
                                       ring_capacity=QUICK.ring_capacity,
                                       max_len=QUICK.max_len)
                         for i in range(4)], device=dev)
        rt.register_pool("src", src.to(rt.device))
        rt.register_pool("dst", torch.zeros(wl.pool_elems,
                                            device=rt.device))
        for d in wl.chains:
            rt.submit(SubmitRequest(chain=d, src_pool="src",
                                    dst_pool="dst", tier="serial"))
        rt.drain_until_idle()
        out.append(rt.pool("dst").cpu())
    assert torch.equal(out[0], out[1])
    assert out[0].abs().sum() > 0


@pytest.mark.cuda
def test_cuda_serve_cell_equals_committed_cell(cuda):
    """The serve cell on the card: a real engine's decode steps there, and
    metrics and counters equal to ``BENCH_perf.json`` exactly."""
    import json
    from pathlib import Path

    from repro_torch.perf.serve_cell import run_serve_cell

    base = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCH_perf.json").read_text())
    metrics, counters = run_serve_cell(0, device=cuda)
    want = base["cells"]["serve/qwen2.5-3b/cap2"]
    assert metrics == want["metrics"]
    assert counters == want["counters"]


def _sharded_run(device, seed=0):
    """4 logical shards, 64 pages of 4,096 fp32 per shard: Zipf-hot moves
    in waves of 8 through the async fabric, a flip with first-touch pulls,
    an ungraceful resize with tickets in flight, evacuate and readmit."""
    from repro_torch.distributed import (
        ShardedDMARuntime, ShardedKVPool, ungraceful_resize)
    from repro_torch.perf.sharded_cell import _zipf_moves

    srt = ShardedDMARuntime(num_shards=4, device=device)
    kv = ShardedKVPool(srt, num_pages=256, page=16, kv_heads=2,
                       head_dim=128)
    g = torch.Generator(device="cpu").manual_seed(seed)
    for name in (kv.POOL_K, kv.POOL_V):
        srt.register_sharded_pool(name, torch.randn(256 * kv.row_elems,
                                                    generator=g),
                                  kv.owner, kv.row_elems)
    src, dst = _zipf_moves(np.random.default_rng(seed), 256, 48, 1.1, 256)
    src, dst = src.tolist(), dst.tolist()
    for i in range(0, len(src), 8):
        kv.move_pages(kv.refs(src[i:i + 8]), kv.refs(dst[i:i + 8]),
                      priority=1, drain=False)
    srt.pump_until_idle()
    srt.drain_until_idle()
    flipped = kv.flip_ownership(kv.alloc_on(0, 4), 2)
    kv.page_rows(flipped[:2])
    kv.alloc_on(3, 5)                      # live pages the loss evacuates
    moving = [kv.move_pages(kv.alloc_on(0, 2), kv.alloc_on(3, 2),
                            drain=False),
              kv.move_pages(kv.alloc_on(3, 3), kv.alloc_on(1, 3),
                            drain=False)]
    srt.pump(2)
    remap = ungraceful_resize(kv, 3)
    kv.alloc_on(1, 4)
    remap.update(kv.evacuate(1))
    kv.readmit(1)
    kv.ensure_resident(flipped)
    assert len(remap) == 16        # 2 re-routed + 5 and 9 evacuated
    assert srt.migration.hop_completions == srt.migration.hops
    assert all(m.hop_completions == m.hops for m in moving)
    return ([torch.from_numpy(srt.gather_pool(n))
             for n in (kv.POOL_K, kv.POOL_V)], remap,
            dataclasses.asdict(srt.migration), srt.fabric.now)


@pytest.mark.cuda
def test_cuda_sharded_migration_matches_the_cpu(cuda):
    """The sharded runtime's migrations on the card, bit-identical to the
    same on the CPU, through descriptor_copy."""
    before = build.launch_counts()["descriptor_copy"]
    got = _sharded_run(cuda)
    assert build.launch_counts()["descriptor_copy"] > before
    want = _sharded_run("cpu")
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert got[1:] == want[1:]


@pytest.mark.cuda
def test_cuda_sharded_cells_equal_committed_cells(cuda):
    """The four sharded mesh cells on the card: metrics and counters equal
    to ``BENCH_perf.json`` exactly, with descriptor_copy launched."""
    import json
    from pathlib import Path

    from repro_torch.perf.sharded_cell import cell_entry

    base = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCH_perf.json").read_text())
    before = build.launch_counts()["descriptor_copy"]
    for mesh in (1, 2, 4, 8):
        key, cell = cell_entry(0, mesh, device=cuda)
        assert cell == base["cells"][key], key
    assert build.launch_counts()["descriptor_copy"] > before


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):                     # a KVCacheView
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [
    ("qwen2.5-3b", 64), ("gemma3-12b", 64), ("dbrx-132b", 64),
    ("gemma3-12b", 256)])
def test_cuda_decode_matches_the_cpu(cuda, arch, head_dim):
    """Reduced configs at head dim 64 (a width the flash kernel takes),
    and gemma3-12b at its published 256, in fp32: prefill (through flash,
    and for dbrx-132b the MoE kernels) and 20 greedy decode steps on the
    card against the same on the CPU, logits within rtol = atol = 1e-4,
    position tags exactly. gemma3-12b's local layers keep 16 slots, which
    the steps wrap."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              head_dim=head_dim, compute_dtype="float32")
    params = init_params(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (3, 24)).astype(np.int32))
    runs, fed = [], []            # both runs are fed the CPU's tokens
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        before = build.launch_counts()["flash_attention"]
        logits, state = prefill(p, {"tokens": tokens.to(dev)}, cfg,
                                max_len=64)
        launched = build.launch_counts()["flash_attention"] - before
        assert launched == (cfg.num_layers if dev == cuda else 0)
        out = [logits.cpu()]
        for step in range(20):
            if dev == "cpu":
                fed.append(out[-1].argmax(-1).to(torch.int32))
            logits, state = decode_step(p, fed[step].to(dev), state, cfg)
            out.append(logits.cpu())
        runs.append((out, _to(state.caches, "cpu")))
    (want, wcaches), (got, gcaches) = runs
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"step {i}: {m}")
    for a, b in zip(gcaches["slots"], wcaches["slots"]):
        assert torch.equal(a.kv_pos, b.kv_pos)
        torch.testing.assert_close(a.k, b.k, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Training on the card: the flash backward kernel, and the kernels without a
# backward refusing grad.
# ---------------------------------------------------------------------------

#: B, S or (Sq, Sk), H, KV, D, DV, causal, window.
FLASH_BWD_CASES = [
    (2, 128, 16, 2, 128, 128, True, None),    # qwen2.5-3b's heads, G 8
    (2, 200, 8, 8, 128, 128, True, 64),       # a window across tile edges
    (1, 150, 8, 2, 128, 128, False, None),    # not causal
    (2, 100, 4, 2, 64, 64, True, None),
    (1, 130, 4, 4, 96, 96, True, None),
    (1, 97, 4, 4, 192, 128, True, None),      # MLA's 192 over 128
    (2, (40, 100), 4, 2, 64, 64, False, 16),  # Sq != Sk, windowed
    (2, 200, 6, 2, 128, 128, True, None),     # an odd group (G 3), S 200
    (2, 150, 4, 4, 128, 128, True, None),     # G 1
    (1, 333, 4, 2, 96, 96, True, 100),        # S 333 at 96, windowed
    (1, 2048, 16, 2, 128, 128, True, None),   # long: the rings wrap often
    (2, 1100, 16, 8, 64, 64, True, 200),      # 288 key tiles: no clusters
    (1, 256, 48, 8, 128, 128, True, None),    # dbrx-132b's heads, G 6
    (2, 256, 32, 32, 96, 96, True, None),     # phi-3-vision's heads, G 1
    (2, 256, 16, 16, 64, 64, True, None),     # seamless's heads, G 1
    (2, (200, 512), 16, 16, 64, 64, False, None),  # its cross-attention
    # The 96 tiles' edges: S 97 and 333, Sq != Sk both ways, a window
    # across tile edges, G 4, rows with no visible key, and phi-3-vision's
    # training batch (576 patches and 512 tokens a row).
    (1, 97, 4, 4, 96, 96, True, None),
    (2, 333, 8, 8, 96, 96, True, None),
    (1, (300, 97), 8, 8, 96, 96, True, None),
    (1, (97, 300), 8, 8, 96, 96, False, None),
    (2, 333, 8, 8, 96, 96, True, 64),
    (1, 333, 32, 8, 96, 96, True, None),
    (1, (300, 64), 8, 8, 96, 96, True, 32),
    (4, 1088, 32, 32, 96, 96, True, None),
    (1, 128, 128, 128, 192, 128, True, None),  # deepseek-v2's 128 MLA heads
    (4, 512, 128, 128, 192, 128, True, None),  # deepseek-v2's training batch
    (2, 300, 8, 8, 192, 128, True, 100),       # MLA, a window across tiles
    (1, 256, 8, 8, 192, 128, False, None),     # MLA, not causal
    (2, (128, 333), 8, 8, 192, 128, False, None),  # MLA, Sk 333
    (1, 200, 8, 2, 192, 128, True, None),      # MLA, summed over G 4
    (2, 200, 8, 2, 16, 16, True, None),        # the reduced configs' heads
    (1, (64, 150), 4, 4, 16, 16, False, None),
    (2, 300, 4, 2, 24, 24, True, 16),          # gemma3-12b's reduced window
    (1, 129, 4, 4, 24, 24, False, None),
    (2, 200, 4, 4, 24, 16, True, None),        # deepseek-v2's reduced MLA
    (1, (100, 150), 4, 4, 24, 16, False, 32),
    (2, 257, 8, 4, 32, 32, True, None),        # qwen3-14b's reduced heads
    (1, 300, 4, 4, 32, 32, True, 100),
    # The narrow kernels' tiles of 128 keys a dK/dV block and 128 queries
    # a pair or dQ block: edges not on them, Sq != Sk, G 1, 4 and 8.
    (1, 2085, 8, 1, 16, 16, True, None),
    (2, (129, 255), 4, 4, 16, 16, True, 16),
    (1, (255, 129), 8, 2, 24, 24, False, None),
    (1, 2085, 4, 1, 24, 24, True, 100),
    (2, 255, 4, 4, 24, 16, True, 16),
    (1, (129, 2085), 4, 4, 24, 16, False, 100),
    (1, (255, 129), 8, 1, 32, 32, True, None),
    (2, 129, 4, 2, 32, 32, True, 100),
]
#: Capped backward cases (every pair but MLA's 192/128, which takes no
#: cap): B, S or (Sq, Sk), H, KV, D, DV, causal, window.
FLASH_BWD_CAP_CASES = [
    (2, 200, 8, 2, 16, 16, True, None),
    (2, 300, 4, 2, 24, 24, True, 16),
    (2, 200, 4, 4, 24, 16, True, None),
    (1, (64, 150), 4, 4, 32, 32, False, None),
    (1, 2085, 8, 1, 16, 16, True, 100),        # the narrow tiles' edges
    (2, (255, 129), 4, 4, 24, 24, False, None),
    (1, (129, 255), 4, 4, 24, 16, True, 16),
    (2, 255, 8, 2, 32, 32, True, None),
    (2, 128, 16, 2, 128, 128, True, None),
    (1, 130, 4, 4, 96, 96, True, 100),
    (1, (300, 97), 32, 8, 96, 96, True, 32),   # G 4, rows without keys
    (2, 333, 8, 8, 96, 96, False, None),
    (2, 100, 4, 2, 64, 64, False, 16),
    (1, 256, 4, 2, 256, 256, True, None),
    (2, 200, 4, 4, 256, 256, True, 64),
]


def _bwd_inputs(cuda, dtype, b, s, h, kv, d, dv, seed):
    sq, sk = s if isinstance(s, tuple) else (s, s)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g).to(dtype).to(cuda)
    k = torch.randn((b, sk, kv, d), generator=g).to(dtype).to(cuda)
    v = torch.randn((b, sk, kv, dv), generator=g).to(dtype).to(cuda)
    dout = torch.randn((b, sq, h, dv), generator=g).to(dtype).to(cuda)
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,s,h,kv,d,dv,causal,window", FLASH_BWD_CASES)
def test_cuda_flash_attention_backward_matches_plain(
        cuda, dtype, tol, b, s, h, kv, d, dv, causal, window):
    """dQ, dK and dV of the backward kernel against
    ``flash_attention_backward_plain`` on the same q, k, v, out, lse and
    dout, within ``tol`` of each reference's largest entry; the forward's
    log-sum-exp against the plain version's; two launches bit-identical,
    both counted under the design ``bwd_design`` names (the tensor cores
    for bf16 at every head-dim pair)."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES_BY_DESIGN, _forward, bwd_design, flash_attention_backward,
        flash_attention_backward_plain, flash_attention_plain)
    q, k, v, dout = _bwd_inputs(cuda, dtype, b, s, h, kv, d, dv, h + d)
    out, lse = _forward(q, k, v, causal, window, with_lse=True)
    _, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    seen = want_lse > -1e29                    # rows with a visible key
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=1e-4,
                               atol=1e-4)
    want = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
    before = build.launch_counts()["flash_attention_bwd"]
    design = bwd_design(d, dv, dtype)
    by_design = dict(LAUNCHES_BY_DESIGN)
    got = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    again = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention_bwd"] == before + 2
    assert LAUNCHES_BY_DESIGN[design] == by_design.get(design, 0) + 2
    assert sum(LAUNCHES_BY_DESIGN.values()) == sum(by_design.values()) + 2
    if dtype == torch.bfloat16:
        assert design == "tensor_core"
    for name, x, y, z in zip("qkv", got, want, again):
        assert x.dtype == dtype and x.shape == y.shape
        assert torch.equal(x, z), f"d{name} differs between launches"
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * float(y.float().abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("softcap", [50.0, 5.0])
@pytest.mark.parametrize("b,s,h,kv,d,dv,causal,window", FLASH_BWD_CAP_CASES)
def test_cuda_flash_attention_backward_softcap_matches_plain(
        cuda, dtype, tol, b, s, h, kv, d, dv, causal, window, softcap):
    """The backward under a logit softcap (P from the capped scores, dS
    times the cap's derivative) against ``flash_attention_backward_plain``
    within ``tol`` of each reference's largest entry, the forward's
    log-sum-exp (of the capped scores) against the plain one, two launches
    bit-identical."""
    from repro_torch.kernels.flash_attention import (
        _forward, flash_attention_backward, flash_attention_backward_plain,
        flash_attention_plain)
    q, k, v, dout = _bwd_inputs(cuda, dtype, b, s, h, kv, d, dv, h + d + 1)
    q = q * 4          # scores of order 10: the cap bites
    out, lse = _forward(q, k, v, causal, window, with_lse=True,
                        softcap=softcap)
    _, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        return_lse=True)
    seen = want_lse > -1e29
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=1e-4,
                               atol=1e-4)
    want = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                          causal=causal, window=window,
                                          softcap=softcap)
    before = build.launch_counts()["flash_attention_bwd"]
    got = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                   window=window, softcap=softcap)
    again = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention_bwd"] == before + 2
    for name, x, y, z in zip("qkv", got, want, again):
        assert x.dtype == dtype and x.shape == y.shape
        assert torch.equal(x, z), f"d{name} differs between launches"
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * float(y.float().abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,kv,d,dv", [(16, 16, 64, 64), (16, 2, 128, 128),
                                       (8, 8, 96, 96), (8, 8, 192, 128),
                                       (8, 4, 256, 256)])
def test_cuda_flash_backward_is_exact_over_keys_with_a_common_mean(
        cuda, h, kv, d, dv, causal):
    """bf16 keys and values whose rows share 99.9 % of their norm (a
    cross-attention over near-identical memory rows): dQ is a small
    difference there, which Delta from the rounded output, or dS as one
    bf16 operand, would swamp. The tensor-core backward (its Delta pass,
    dQ on dS's two bf16 parts) holds dQ, dK and dV at cosine 0.9999 to
    fp64 autograd on the same inputs, MLA's (192, 128) and gemma3-12b's
    (256, 256) included."""
    from repro_torch.kernels.flash_attention import (
        _forward, flash_attention_backward)
    g = torch.Generator(device="cpu").manual_seed(h + d)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    b, s = 2, 256
    k = rnd(1, 1, kv, d) * 3 + 0.05 * rnd(b, s, kv, d)
    v = rnd(1, 1, kv, dv) * 3 + 0.05 * rnd(b, s, kv, dv)
    q, k, v, do = (x.to(torch.bfloat16).to(cuda)
                   for x in (rnd(b, s, h, d), k, v, rnd(b, s, h, dv)))
    out, lse = _forward(q, k, v, causal, None, with_lse=True)
    got = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    kk, vv = (x.repeat_interleave(h // kv, dim=2) for x in leaves[1:])
    sc = torch.einsum("bqhd,bkhd->bhqk", leaves[0], kk) * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool,
                                        device=cuda).tril(), float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vv)
    want = torch.autograd.grad(ref, leaves, do.double())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.double().flatten(), w.flatten()
        cos = float(a @ w / (a.norm() * w.norm()))
        assert cos >= 0.9999, (name, cos)


#: gemma3-12b's heads of 256: B, S or (Sq, Sk), H, KV, causal, window.
FLASH_BWD_256_CASES = [
    (2, 512, 16, 8, True, None),         # its heads, G 2
    (1, 1024, 16, 8, True, 512),         # a local layer's window
    (2, 300, 8, 8, True, 100),           # G 1, a window across tiles
    (1, 200, 4, 2, False, None),         # not causal
    (2, (64, 200), 4, 2, False, 16),     # Sq != Sk, windowed
    (1, 333, 6, 2, True, None),          # G 3, S 333
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,s,h,kv,causal,window", FLASH_BWD_256_CASES)
def test_cuda_flash_attention_backward_head256_matches_plain(
        cuda, dtype, tol, b, s, h, kv, causal, window):
    """The backward at (256, 256) (bf16 on the tensor cores through
    ``dkdv_256_kernel`` and ``dq_256_kernel``, fp32 on the CUDA cores)
    against ``flash_attention_backward_plain`` within ``tol`` of each
    reference's largest entry, two launches bit-identical."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES_BY_DESIGN, _forward, bwd_design, flash_attention_backward,
        flash_attention_backward_plain)
    q, k, v, dout = _bwd_inputs(cuda, dtype, b, s, h, kv, 256, 256, h + b)
    out, lse = _forward(q, k, v, causal, window, with_lse=True)
    want = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
    design = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    assert bwd_design(256, 256, dtype) == design
    before = (build.launch_counts()["flash_attention_bwd"],
              LAUNCHES_BY_DESIGN[design])
    got = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    again = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert (build.launch_counts()["flash_attention_bwd"],
            LAUNCHES_BY_DESIGN[design]) == (before[0] + 2, before[1] + 2)
    for name, x, y, z in zip("qkv", got, want, again):
        assert x.dtype == dtype and x.shape == y.shape
        assert torch.equal(x, z), f"d{name} differs between launches"
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * float(y.float().abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_flash_attention_autograd_matches_plain_autograd(cuda, dtype,
                                                             tol):
    """``flash_attention`` under autograd on the card (forward and
    backward kernels) against autograd of the plain forward."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v, dout = _bwd_inputs(cuda, dtype, 2, 256, 16, 2, 128, 128, 7)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(build.launch_counts())
    out = flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        flash_attention_plain(*plain, causal=True), plain, dout)
    for x, y in zip(got, want):
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * float(y.float().abs().max())


@pytest.mark.cuda
def test_cuda_kernels_without_a_backward_refuse_grad(cuda):
    """Under autograd, every kernel without a backward raises instead of
    returning a tensor cut from the graph; under no_grad it runs. The MoE
    kernels have their backwards: their outputs carry a ``grad_fn``."""
    from repro_torch.kernels.descriptor_copy import descriptor_copy
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_gather
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.prefetch_pipeline import prefetched_chain_copy
    from repro_torch.kernels.quantize_copy import quantize_copy

    tokens = torch.randn((8, 64), device=cuda, requires_grad=True)
    idx = torch.tensor([0, 3, -1, 5], dtype=torch.int32, device=cuda)
    inv = torch.tensor([[0], [-1], [-1], [1], [-1], [3], [-1], [-1]],
                       dtype=torch.int32, device=cuda)
    slots = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32, device=cuda)
    owner = torch.tensor([0, 0, 1, -1], dtype=torch.int32, device=cuda)
    weights = torch.rand((2, 2), device=cuda, requires_grad=True)
    rows = torch.randn((4, 64), device=cuda, requires_grad=True)
    q = torch.randn((2, 4, 64), device=cuda, requires_grad=True)
    pages = torch.randn((4, 16, 2, 64), device=cuda)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([20, 5], dtype=torch.int32, device=cuda)
    pool = torch.randn((8, 256), device=cuda, requires_grad=True)
    sidx, didx = np.array([0, 1]), np.array([2, 3])
    calls = {
        "paged_attention": lambda: paged_attention(q, pages, pages, tables,
                                                   lengths),
        "quantize_copy": lambda: quantize_copy(sidx, didx, pool,
                                               pool.detach().clone()),
        "descriptor_copy": lambda: descriptor_copy(sidx, didx, pool,
                                                   pool.detach().clone()),
        "prefetched_chain_copy": lambda: prefetched_chain_copy(
            sidx, didx, pool, pool.detach().clone()),
    }
    before = build.launch_counts()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            call()
    assert build.launch_counts() == before
    with torch.no_grad():
        for call in calls.values():
            call()
    gathered = moe_gather(idx, tokens, inv_slot=inv)
    combined = moe_combine(slots, weights, rows, token_idx=owner)
    assert type(gathered.grad_fn).__name__ == "MoEGatherFnBackward"
    assert type(combined.grad_fn).__name__ == "MoECombineFnBackward"
    torch.cuda.synchronize()

# ---------------------------------------------------------------------------
# AdamW: the fused update and the sum of squares (csrc/adamw.cu)
# ---------------------------------------------------------------------------

ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8)


def _adamw_leaf(device, n, p_dtype, g_dtype, offset, seed):
    """(p, g, m, v) of n elements, each a view ``offset`` elements into its
    buffer, with the state of a few steps in: m of either sign, v >= 0."""
    gen = torch.Generator(device).manual_seed(seed)

    def draw(dtype, scale, positive=False):
        x = torch.randn(n + offset, generator=gen, device=device) * scale
        x = x.square() if positive else x
        return x.to(dtype)[offset:]
    return (draw(p_dtype, 0.05), draw(g_dtype, 0.3), draw(torch.float32, 0.01),
            draw(torch.float32, 0.03, positive=True))


def _adamw_scalars(device, clip):
    """scale, lr, b1c, b2c as ``optim.apply`` makes them at step 3."""
    step = torch.tensor(3, dtype=torch.int32, device=device).float()
    scale = (torch.tensor(0.37, device=device) if clip
             else torch.ones((), device=device))
    return (scale, torch.tensor(3e-4, device=device),
            1 - torch.pow(ADAMW["b1"], step), 1 - torch.pow(ADAMW["b2"], step))


@pytest.mark.cuda
@pytest.mark.parametrize("clip,wd", [(False, 0.0), (False, 0.1), (True, 0.0),
                                     (True, 0.1)])
@pytest.mark.parametrize("offset", [0, 1])      # 1: unaligned, scalar path
@pytest.mark.parametrize("n", [1, 7, 4097, (1 << 26) + 5])
@pytest.mark.parametrize("p_dtype,g_dtype", adamw.UPDATE_PAIRS,
                         ids=["f32-f32", "bf16-bf16", "bf16-f32"])
def test_cuda_adamw_update_matches_plain(cuda, p_dtype, g_dtype, n, offset,
                                         clip, wd):
    p, g, m, v = _adamw_leaf(cuda, n, p_dtype, g_dtype, offset, 40)
    scalars = _adamw_scalars(cuda, clip)
    want = [t.clone() for t in (p, m, v)]
    adamw.adamw_update_plain(want[0], g, want[1], want[2], *scalars, **ADAMW,
                             weight_decay=wd)
    before = build.launch_counts()["adamw_update"]
    adamw.adamw_update(p, g, m, v, *scalars, **ADAMW, weight_decay=wd)
    torch.cuda.synchronize()
    assert build.launch_counts()["adamw_update"] == before + 1
    for got, ref in zip((p, m, v), want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,offset", [
    (torch.float32, (1,), 0),
    (torch.bfloat16, (7,), 1),
    (torch.float32, (4097,), 1),
    (torch.bfloat16, ((1 << 26) + 5,), 0),
    (torch.bfloat16, (16, 6144, 10752), 0),     # dbrx-132b's expert leaf
    (torch.float32, (151936, 2048), 0),         # qwen2.5-3b's embedding
])
def test_cuda_sum_squares_repeats_and_matches_fp64(cuda, dtype, shape, offset):
    n = int(np.prod(shape))
    x = torch.empty(n + offset, dtype=dtype, device=cuda)
    x.normal_(0.0, 0.02, generator=torch.Generator(cuda).manual_seed(41))
    x = x[offset:].view(shape)
    before = build.launch_counts()["sum_squares"]
    got = adamw.sum_squares([x])
    again = adamw.sum_squares([x])
    flat = x.reshape(-1)
    want = sum(float(flat[i:i + (1 << 26)].double().square().sum())
               for i in range(0, n, 1 << 26))
    torch.cuda.synchronize()
    assert build.launch_counts()["sum_squares"] == before + 4
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, again)
    assert abs(float(got) - want) <= 1e-5 * want


@pytest.mark.cuda
def test_cuda_sum_squares_over_many_tensors(cuda):
    xs = [_rows(s, dt, cuda, i) for i, (s, dt) in enumerate([
        ((33, 64), torch.bfloat16), ((0,), torch.float32),
        ((4097,), torch.float32), (((1 << 20) + 3,), torch.bfloat16)])]
    xs[2] = xs[2][1:]                                # unaligned
    before = build.launch_counts()["sum_squares"]
    got = adamw.sum_squares(xs)
    want = sum(float(x.double().square().sum()) for x in xs)
    torch.cuda.synchronize()
    assert build.launch_counts()["sum_squares"] == before + 3 + 1
    assert torch.equal(got, adamw.sum_squares(xs))
    assert abs(float(got) - want) <= 1e-5 * want
    assert float(got) == pytest.approx(float(adamw.sum_squares_plain(xs)),
                                       rel=1e-5)


def _mixed_tree(device, seed, grads=False):
    """A tree of bf16 and fp32 leaves at odd sizes; as gradients, one bf16
    leaf's in fp32 (a microbatch sum's)."""
    shapes = {"embed": ((33, 64), torch.bfloat16, torch.bfloat16),
              "w": ((64, 48), torch.float32, torch.float32),
              "b": ((7,), torch.float32, torch.float32),
              "norm": ((4097,), torch.bfloat16, torch.bfloat16),
              "experts": ((3, 40, 24), torch.bfloat16, torch.float32)}
    return {k: _rows(s, gd if grads else pd, device, seed + i) / 50
            for i, (k, (s, pd, gd)) in enumerate(shapes.items())}


@pytest.mark.cuda
@pytest.mark.parametrize("pass_gnorm", [True, False])
def test_cuda_apply_matches_plain_apply(cuda, monkeypatch, pass_gnorm):
    """Three AdamW steps with clipping and weight decay on the card, the
    kernels against the plain bodies (on the card too): bit-identical
    given the same ``gnorm``; without it the norms agree within a
    relative 1e-5, and so does the state (a parameter in bf16 within one
    of its ulps)."""
    import repro_torch.optim.optimizer as optimizer
    cfg = optim.AdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=0.5,
                            warmup_steps=2, total_steps=10)
    mine = _mixed_tree(cuda, 50)
    plain = {k: v.clone() for k, v in mine.items()}
    s_mine, s_plain = optim.init(mine), optim.init(plain)
    n = len(mine)
    for step in range(3):
        g = _mixed_tree(cuda, 60 + 10 * step, grads=True)
        gnorm = optim.global_norm(g) if pass_gnorm else None
        before = build.launch_counts()
        _, s_mine, m_mine = optim.apply(cfg, mine, g, s_mine, gnorm=gnorm)
        torch.cuda.synchronize()
        after = build.launch_counts()
        assert after["adamw_update"] - before["adamw_update"] == n
        assert after["sum_squares"] - before["sum_squares"] == \
            (0 if pass_gnorm else n + 1)
        with monkeypatch.context() as mp:
            mp.setattr(optimizer, "adamw_update", adamw.adamw_update_plain)
            mp.setattr(optimizer, "sum_squares", adamw.sum_squares_plain)
            _, s_plain, m_plain = optim.apply(cfg, plain, g, s_plain,
                                              gnorm=gnorm)
        assert build.launch_counts() == after
        assert float(m_mine["grad_norm"]) == pytest.approx(
            float(m_plain["grad_norm"]), rel=0 if pass_gnorm else 1e-5)
        for tree_m, tree_p in ((mine, plain), (s_mine.m, s_plain.m),
                               (s_mine.v, s_plain.v)):
            for k in tree_m:
                a, b = tree_m[k], tree_p[k]
                if pass_gnorm:
                    assert torch.equal(a, b), k
                else:
                    rtol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-5
                    torch.testing.assert_close(
                        a.float(), b.float(), rtol=rtol,
                        atol=1e-5 * float(b.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["p_strided", "m_strided", "v_strided",
                                  "fp16", "bf16_fp16"])
def test_cuda_adamw_update_raises_outside_its_domain(cuda, case):
    p, g, m, v = _adamw_leaf(cuda, 64 * 32, torch.float32, torch.float32, 0,
                             42)
    p, g, m, v = (t.view(64, 32) for t in (p, g, m, v))
    if case.endswith("_strided"):          # the same shape, column-major
        p, m, v = (x.t().contiguous().t() if name == case[0] else x
                   for name, x in (("p", p), ("m", m), ("v", v)))
        match = "not contiguous"
    else:
        p = p.to(torch.float16 if case == "fp16" else torch.bfloat16)
        g = g.to(torch.float16)
        match = "not supported"
    before = build.launch_counts()
    with pytest.raises((TypeError, ValueError), match=match):
        adamw.adamw_update(p, g, m, v, *_adamw_scalars(cuda, True), **ADAMW,
                           weight_decay=0.1)
    assert build.launch_counts() == before
