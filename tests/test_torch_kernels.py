"""Port parity: the kernels' plain versions against the Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernel
needs the card). The Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` and ``tests/test_transform.py`` run them. The
copy must match bit for bit. kv8 must be within one quantisation step of
the interpreted Pallas kernel (the tolerance of ``tests/test_transform.py``)
and exact against the reference's numpy oracle ``kv8_roundtrip_np`` per
row: XLA on the CPU strays from that oracle by up to one ulp.

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.descriptor_copy import (  # noqa: E402
    descriptor_copy as jcopy,
    descriptor_copy_bucketed as jcopy_b,
)
from repro.core.transform import kv8_roundtrip_np  # noqa: E402
from repro.kernels.quantize_copy import (  # noqa: E402
    quantize_copy_bucketed as jquant_b,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.descriptor_copy import (  # noqa: E402
    chain_copy,
    descriptor_copy,
    descriptor_copy_bucketed,
    descriptor_copy_plain,
)
from repro_torch.kernels.quantize_copy import (  # noqa: E402
    quantize_copy,
    quantize_copy_bucketed,
    quantize_copy_plain,
)

I = dict(interpret=True)


def _j(sidx, didx, src, dst, **kw):
    return np.asarray(jcopy(jnp.asarray(sidx, jnp.int32),
                            jnp.asarray(didx, jnp.int32),
                            jnp.asarray(src), jnp.asarray(dst), **I, **kw))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("unit", [128, 3])
def test_descriptor_copy_plain_matches_pallas(dtype, unit):
    rng = np.random.default_rng(unit)
    src = rng.integers(-9, 9, (16, unit)).astype(dtype)
    dst = rng.integers(-9, 9, (16, unit)).astype(dtype)
    sidx = np.array([3, -1, 7, 0, 15, 2], np.int32)
    didx = np.array([0, 4, 9, 15, -1, 6], np.int32)
    want = _j(sidx, didx, src, dst)
    d = torch.from_numpy(dst.copy())
    got = descriptor_copy_plain(sidx, didx, torch.from_numpy(src), d)
    assert got is d                                # in place, like the alias
    np.testing.assert_array_equal(got.numpy(), want)


def test_descriptor_copy_bf16_matches_pallas():
    rng = np.random.default_rng(4)
    src = rng.standard_normal((8, 128)).astype(np.float32)
    dst = rng.standard_normal((8, 128)).astype(np.float32)
    sidx, didx = np.array([1, 6, 2, 4]), np.array([0, 3, 7, 5])
    want = np.asarray(jcopy(jnp.asarray(sidx, jnp.int32),
                            jnp.asarray(didx, jnp.int32),
                            jnp.asarray(src, jnp.bfloat16),
                            jnp.asarray(dst, jnp.bfloat16), **I)
                      .astype(jnp.float32))
    got = descriptor_copy(sidx, didx,
                          torch.from_numpy(src).to(torch.bfloat16),
                          torch.from_numpy(dst).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_descriptor_copy_bucketed_padding_matches_pallas():
    rng = np.random.default_rng(5)
    src = rng.standard_normal((12, 128)).astype(np.float32)
    dst = rng.standard_normal((12, 128)).astype(np.float32)
    sidx, didx = np.array([5, 1, 9], np.int32), np.array([2, 11, 0], np.int32)
    want = np.asarray(jcopy_b(jnp.asarray(sidx), jnp.asarray(didx),
                              jnp.asarray(src), jnp.asarray(dst),
                              n_bucket=8, **I))
    got = descriptor_copy_bucketed(sidx, didx, torch.from_numpy(src),
                                   torch.from_numpy(dst.copy()), n_bucket=8)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="exceed bucket"):
        descriptor_copy_bucketed(sidx, didx, torch.from_numpy(src),
                                 torch.from_numpy(dst), n_bucket=2)


def test_descriptor_copy_duplicates_last_write_wins_like_pallas_grid():
    rng = np.random.default_rng(6)
    src = rng.standard_normal((8, 128)).astype(np.float32)
    dst = rng.standard_normal((8, 128)).astype(np.float32)
    sidx = np.array([0, 1, 2, 3, 4], np.int32)
    didx = np.array([5, 6, 5, 6, 5], np.int32)
    want = _j(sidx, didx, src, dst)              # in-order grid: last wins
    got = descriptor_copy(sidx, didx, torch.from_numpy(src),
                          torch.from_numpy(dst.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[5], src[4])


def test_descriptor_copy_aliased_pool_reads_pre_call_snapshot():
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((8, 128)).astype(np.float32)
    # Row 1 is written by descriptor 0 and read by descriptor 1; row 2 is
    # written by descriptor 1 and read by descriptor 2 (a move chain).
    sidx = np.array([0, 1, 2], np.int32)
    didx = np.array([1, 2, 3], np.int32)
    p = jnp.asarray(pool)
    want = np.asarray(jcopy(jnp.asarray(sidx), jnp.asarray(didx), p, p, **I))
    t = torch.from_numpy(pool.copy())
    got = descriptor_copy(sidx, didx, t, t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[1:4], pool[0:3])


def test_descriptor_copy_ref_and_chain_copy():
    rng = np.random.default_rng(8)
    src = rng.standard_normal((6, 4)).astype(np.float32)
    dst = rng.standard_normal((6, 4)).astype(np.float32)
    sidx, didx = np.array([4, -1, 1]), np.array([0, 2, 5])
    ref = tref.descriptor_copy_ref(sidx, didx, torch.from_numpy(src),
                                   torch.from_numpy(dst))
    np.testing.assert_array_equal(ref.numpy(), _j(sidx, didx, src, dst))
    from repro_torch.core.descriptor import DescriptorArray
    d = DescriptorArray.create([4, 1, 3], [0, 5, 2], [1, 1, 1],
                               nxt=[2, -1, 1])
    got = chain_copy(d, torch.from_numpy(src), torch.from_numpy(dst.copy()))
    want = dst.copy()
    want[0], want[2], want[5] = src[4], src[3], src[1]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_bucket", [4, 8])
def test_quantize_copy_plain_matches_pallas(n_bucket):
    rows, unit = 8, 512
    rng = np.random.default_rng(n_bucket)
    src = (rng.standard_normal((rows, unit)) * 2).astype(np.float32)
    src[3, :256] = 0.0                           # an all-zero block
    src[5, :256] *= np.logspace(-3, 1, 256)      # mixed magnitudes
    dst = rng.standard_normal((rows, unit)).astype(np.float32)
    sidx = np.array([0, 3, 5], np.int32)
    didx = np.array([1, 2, 4], np.int32)
    want = np.asarray(jquant_b(jnp.asarray(sidx), jnp.asarray(didx),
                               jnp.asarray(src), jnp.asarray(dst),
                               n_bucket=n_bucket, **I))
    got = quantize_copy_bucketed(sidx, didx, torch.from_numpy(src),
                                 torch.from_numpy(dst.copy()),
                                 n_bucket=n_bucket).numpy()
    step = float(np.abs(src).max()) / 127.0
    assert float(np.max(np.abs(got - want))) <= step   # stated tolerance
    oracle = dst.copy()
    for s_, t_ in zip(sidx, didx):
        oracle[t_] = kv8_roundtrip_np(src[s_])
    np.testing.assert_array_equal(got, oracle)         # exact
    assert np.all(got[2, :256] == 0.0)                 # scale floor


def test_quantize_copy_ties_round_half_to_even():
    # max|x| = 127 makes the scale exactly 1.0, so x/scale = x: .5 ties.
    row = np.zeros(256, np.float32)
    row[0] = 127.0
    row[1:7] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    src = np.stack([row, row]).astype(np.float32)
    out = quantize_copy([0], [1], torch.from_numpy(src),
                        torch.from_numpy(src.copy())).numpy()
    np.testing.assert_array_equal(out[1, 1:7], [0, 2, 2, -0, -2, -2])


def test_quantize_copy_bf16_plain_computes_in_fp32():
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    src16 = src.to(torch.bfloat16)
    out = quantize_copy_plain([2], [0], src16, torch.zeros_like(src16))
    from repro_torch.core.transform import kv8_roundtrip
    want = kv8_roundtrip(src16[2].float()).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0], want)


def test_wrappers_reject_bad_inputs():
    f = torch.zeros((4, 256))
    with pytest.raises(ValueError, match="not a multiple"):
        quantize_copy([0], [1], torch.zeros((4, 100)), torch.zeros((4, 100)))
    with pytest.raises(TypeError, match="not supported"):
        quantize_copy([0], [1], f.to(torch.float16), f.to(torch.float16))
    with pytest.raises(TypeError, match="dtype mismatch"):
        descriptor_copy([0], [1], f, f.to(torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        descriptor_copy([0], [1], f.t(), f.t())
    with pytest.raises(ValueError, match="row width"):
        descriptor_copy([0], [1], f, torch.zeros((4, 128)))
    with pytest.raises(IndexError, match="out of range"):
        descriptor_copy([4], [1], f, f.clone())
    with pytest.raises(ValueError, match=r"\(rows, unit\)"):
        descriptor_copy([0], [1], torch.zeros(8), torch.zeros(8))


def test_cpu_tensors_never_launch_a_kernel():
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.prefetch_pipeline import prefetched_chain_copy
    build.reset_launches()
    f = torch.ones((4, 256))
    descriptor_copy([0], [1], f, f.clone())
    quantize_copy([0], [1], f, f.clone())
    prefetched_chain_copy([0], [1], f, f.clone())
    paged_attention(torch.ones((1, 2, 8)), torch.ones((2, 4, 2, 8)),
                    torch.ones((2, 4, 2, 8)),
                    torch.zeros((1, 1), dtype=torch.int32),
                    torch.full((1,), 3, dtype=torch.int32))
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_gather
    q = torch.ones((1, 8, 2, 64))
    flash_attention(q, q, q)
    from repro_torch.kernels.moe_dispatch import (moe_combine_backward,
                                                  moe_gather_backward)
    rows = moe_gather(torch.tensor([0, -1], dtype=torch.int32), f)
    slots = torch.tensor([[0, 1]], dtype=torch.int32)
    moe_combine(slots, torch.ones((1, 2)), rows)
    moe_gather_backward(slots, rows)
    moe_combine_backward(slots, torch.ones((1, 2)), rows, f[:1])
    from repro_torch.kernels.adamw import adamw_update, sum_squares
    one = torch.ones(())
    adamw_update(f.clone(), f, torch.zeros_like(f), torch.zeros_like(f),
                 one, one, one, one, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1)
    sum_squares([f, rows])
    assert build.launch_counts() == {"descriptor_copy": 0,
                                     "quantize_copy": 0,
                                     "prefetch_pipeline": 0,
                                     "paged_attention": 0,
                                     "flash_attention": 0,
                                     "flash_attention_bwd": 0,
                                     "moe_gather": 0,
                                     "moe_combine": 0,
                                     "moe_gather_bwd": 0,
                                     "moe_combine_bwd": 0,
                                     "adamw_update": 0,
                                     "sum_squares": 0}


# ---------------------------------------------------------------------------
# The CUDA route's rules, modelled in plain Python (kernels/ref.py): the
# launch function's host pass (drop -1, cut at MAX_TABLE) and the kernel's
# last-write rule over one launch's table.
# ---------------------------------------------------------------------------

def _dup_streams(rng, n, rows):
    """Seeded streams with -1 on both sides and many repeated
    destinations (a few distinct rows for n descriptors)."""
    return (rng.integers(-1, rows, n),
            rng.integers(-1, max(n // 8, 2), n))


@pytest.mark.parametrize("n", [1, 2, 4100])
def test_last_write_keep_matches_keep_last(n):
    from repro_torch.core.engine import keep_last
    rng = np.random.default_rng(20 + n)
    sidx, didx = _dup_streams(rng, n, 64)
    active = (sidx >= 0) & (didx >= 0)
    want = keep_last(didx, active)[active]
    got = tref.last_write_keep(didx[active])
    np.testing.assert_array_equal(got, want)
    (s, d), = tref.table_launches(sidx, didx, cap=max(n, 1))
    np.testing.assert_array_equal(d, didx[active])
    np.testing.assert_array_equal(tref.last_write_keep(d), want)


@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4100])
def test_table_route_model_matches_pallas_and_plain(n, same):
    """The kernel's route (the host pass's launches in stream order, the
    last-write rule per launch, reads of the pool before the call) equals
    the Pallas kernel's in-order grid and the plain version, also when the
    call is cut into launches of 7 and when src is dst."""
    rng = np.random.default_rng(30 + n)
    rows, unit = 512, 8
    src = rng.standard_normal((rows, unit)).astype(np.float32)
    dst = src if same else rng.standard_normal((rows, unit)).astype(
        np.float32)
    sidx, didx = _dup_streams(rng, n, rows)
    p = jnp.asarray(src)
    want = np.asarray(jcopy(jnp.asarray(sidx, jnp.int32),
                            jnp.asarray(didx, jnp.int32), p,
                            p if same else jnp.asarray(dst), **I))
    s = torch.from_numpy(src.copy())
    d = s if same else torch.from_numpy(dst.copy())
    for cap in (None, 7):
        got = tref.table_copy_ref(sidx, didx, s, d, cap=cap)
        np.testing.assert_array_equal(got.numpy(), want)
    got = descriptor_copy_plain(sidx, didx, s, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_launches_cut_at_the_largest_capacity():
    from repro_torch.kernels.descriptor_copy import MAX_TABLE
    n = 2 * MAX_TABLE + 5
    sidx, didx = np.arange(n), np.arange(n)[::-1].copy()
    cuts = tref.table_launches(sidx, didx)
    assert [s.size for s, _ in cuts] == [MAX_TABLE, MAX_TABLE, 5]
    assert all(s.dtype == np.int32 for s, _ in cuts)
    np.testing.assert_array_equal(np.concatenate([s for s, _ in cuts]), sidx)
    np.testing.assert_array_equal(np.concatenate([d for _, d in cuts]), didx)
    # -1 entries are dropped before the cut, in chain order.
    sidx[::2] = -1
    cuts = tref.table_launches(sidx, didx)
    assert [s.size for s, _ in cuts] == [MAX_TABLE, n // 2 - MAX_TABLE]
    np.testing.assert_array_equal(np.concatenate([s for s, _ in cuts]),
                                  sidx[sidx >= 0])
    assert tref.table_launches(np.zeros(0, np.int64),
                               np.zeros(0, np.int64)) == []
    assert len(tref.table_launches([-1, 0], [3, -1])) == 0


@pytest.mark.parametrize("kind", ["list", "numpy", "torch"])
def test_descriptor_copy_bucketed_still_raises_above_the_bucket(kind):
    sidx, didx = [0, 1, 2], [3, 2, 1]
    if kind == "numpy":
        sidx, didx = np.array(sidx), np.array(didx)
    elif kind == "torch":
        sidx, didx = torch.tensor(sidx), torch.tensor(didx)
    src, dst = torch.ones((4, 16)), torch.zeros((4, 16))
    with pytest.raises(ValueError, match="exceed bucket"):
        descriptor_copy_bucketed(sidx, didx, src, dst, n_bucket=2)
    assert not dst.any()
    descriptor_copy_bucketed(sidx, didx, src, dst, n_bucket=3)
    assert dst[1:].all() and not dst[0].any()


@pytest.mark.parametrize("which", ["descriptor_copy", "bucketed",
                                   "prefetched_chain_copy"])
def test_out_of_range_raises_before_the_destination_changes(which):
    from repro_torch.kernels.prefetch_pipeline import prefetched_chain_copy
    fn = {"descriptor_copy": descriptor_copy,
          "bucketed": lambda *a: descriptor_copy_bucketed(*a, n_bucket=4),
          "prefetched_chain_copy": prefetched_chain_copy}[which]
    src, dst = torch.ones((4, 16)), torch.zeros((4, 16))
    for sidx, didx in (([0, 4], [1, 2]), ([0, 1], [1, 4])):
        with pytest.raises(IndexError, match="out of range"):
            fn(np.array(sidx), np.array(didx), src, dst)
        assert not dst.any()
