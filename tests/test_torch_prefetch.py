"""Port parity: the §II-C prefetched chain copy and translate_chain.

On the CPU the wrapper runs its plain PyTorch version (the CUDA kernel
needs the card); the Pallas kernel runs in interpret mode, as
``tests/test_properties.py`` runs it. The copy must match bit for bit.
``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.chain import from_pages as jfrom_pages  # noqa: E402
from repro.kernels.prefetch_pipeline import (  # noqa: E402
    prefetched_chain_copy as jprefetch,
)
from repro.mmu import PageTable as JPageTable  # noqa: E402
from repro.runtime.lowering import (  # noqa: E402
    translate_chain as jtranslate,
)
from repro_torch.core.chain import from_pages  # noqa: E402
from repro_torch.core.speculation import FixedDepth  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.prefetch_pipeline import (  # noqa: E402
    clamp_depth,
    prefetched_chain_copy,
    prefetched_chain_copy_plain,
)
from repro_torch.mmu import PageTable  # noqa: E402
from repro_torch.runtime.lowering import translate_chain  # noqa: E402


def _j(sidx, didx, src, dst, depth, same=False):
    s = jnp.asarray(src)
    d = s if same else jnp.asarray(dst)
    return np.asarray(jprefetch(jnp.asarray(sidx, jnp.int32),
                                jnp.asarray(didx, jnp.int32), s, d,
                                depth=depth, interpret=True))


def _pools(rng, rows, unit, dtype):
    src = rng.integers(-99, 99, (rows, unit)).astype(dtype)
    dst = rng.integers(-99, 99, (rows, unit)).astype(dtype)
    return src, dst


@pytest.mark.parametrize("depth", [2, 3, 4, 5, 6, 7, 8])
def test_prefetch_plain_matches_pallas_by_depth(depth):
    rng = np.random.default_rng(depth)
    src, dst = _pools(rng, 24, 128, np.float32)
    sidx = rng.choice(24, 12, replace=False).astype(np.int32)
    didx = rng.choice(24, 12, replace=False).astype(np.int32)
    want = _j(sidx, didx, src, dst, depth)
    got = prefetched_chain_copy(sidx, didx, torch.from_numpy(src),
                                torch.from_numpy(dst.copy()), depth=depth)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,depth", [(0, 4), (1, 4), (1, 2), (3, 8),
                                     (2, 5)])
def test_prefetch_plain_short_chains(n, depth):
    """n < depth and n = 0: the ring is deeper than the chain. The Pallas
    kernel cannot trace an empty chain (its warm-up indexes entry 0), so
    n = 0 is held to the untouched destination."""
    rng = np.random.default_rng(10 + n)
    src, dst = _pools(rng, 8, 16, np.int32)
    sidx = rng.choice(8, n, replace=False).astype(np.int32)
    didx = rng.choice(8, n, replace=False).astype(np.int32)
    want = _j(sidx, didx, src, dst, depth) if n else dst
    got = prefetched_chain_copy(sidx, didx, torch.from_numpy(src),
                                torch.from_numpy(dst.copy()), depth=depth)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("unit", [128, 3])
def test_prefetch_plain_negative_indices_clamp_to_row_zero(unit):
    """-1 reads row 0 and writes row 0; it is not skipped."""
    rng = np.random.default_rng(unit)
    src, dst = _pools(rng, 16, unit, np.float32)
    sidx = np.array([3, -1, 7, 5, 9, 2], np.int32)
    didx = np.array([4, 6, -1, 8, 11, 12], np.int32)
    want = _j(sidx, didx, src, dst, 3)
    got = prefetched_chain_copy(sidx, didx, torch.from_numpy(src),
                                torch.from_numpy(dst.copy()), depth=3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[6], src[0])      # -1 read row 0
    np.testing.assert_array_equal(want[0], src[7])      # -1 wrote row 0


def test_prefetch_plain_duplicate_destinations_take_the_last():
    rng = np.random.default_rng(5)
    src, dst = _pools(rng, 16, 32, np.float32)
    sidx = np.array([1, 2, 3, 4, 5, -1], np.int32)
    didx = np.array([7, 7, 9, 7, -1, 9], np.int32)       # -1 -> row 0
    want = _j(sidx, didx, src, dst, 2)
    got = prefetched_chain_copy(sidx, didx, torch.from_numpy(src),
                                torch.from_numpy(dst.copy()), depth=2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[7], src[4])
    np.testing.assert_array_equal(want[9], src[0])


@pytest.mark.parametrize("depth", [2, 4])
def test_prefetch_plain_src_is_dst_reads_the_pool_before_the_call(depth):
    """An in-pool move chain whose rows overlap: every read sees the pool
    as it was before the call."""
    rng = np.random.default_rng(depth)
    pool = rng.standard_normal((16, 64)).astype(np.float32)
    sidx = np.arange(0, 8, dtype=np.int32)
    didx = np.arange(3, 11, dtype=np.int32)
    want = _j(sidx, didx, pool, None, depth, same=True)
    t = torch.from_numpy(pool.copy())
    got = prefetched_chain_copy(sidx, didx, t, t, depth=depth)
    assert got is t
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[3:11], pool[0:8])


def test_prefetch_ref_is_pure_and_agrees():
    rng = np.random.default_rng(7)
    src, dst = _pools(rng, 12, 8, np.float32)
    sidx = np.array([0, -1, 4, 4], np.int64)
    didx = np.array([2, 2, -1, 5], np.int64)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    out = tref.prefetched_chain_copy_ref(sidx, didx, s, d)
    np.testing.assert_array_equal(d.numpy(), dst)        # inputs untouched
    np.testing.assert_array_equal(out.numpy(), _j(sidx, didx, src, dst, 2))


def test_prefetch_op_takes_depth_from_default_policy(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "prefetched_chain_copy",
                        lambda *a, depth: seen.append(depth) or a[3])
    src = torch.zeros((4, 2))
    ops.prefetched_chain_copy_op([0], [1], src, src.clone())
    ops.prefetched_chain_copy_op([0], [1], src, src.clone(), depth=6)
    ops.prefetched_chain_copy_op([0], [1], src, src.clone(),
                                 depth=FixedDepth(3))
    assert seen == [4, 6, 3]


def test_prefetch_op_matches_pallas_op_on_cpu():
    from repro.kernels.ops import prefetched_chain_copy_op as jop
    rng = np.random.default_rng(9)
    src, dst = _pools(rng, 10, 16, np.float32)
    sidx = np.array([9, 8, -1, 1, 0], np.int32)
    didx = np.array([0, 1, 2, 2, 3], np.int32)
    want = np.asarray(jop(jnp.asarray(sidx), jnp.asarray(didx),
                          jnp.asarray(src), jnp.asarray(dst)))
    got = ops.prefetched_chain_copy_op(sidx, didx, torch.from_numpy(src),
                                       torch.from_numpy(dst.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefetch_clamp_depth_matches_the_tpu_kernel():
    assert [clamp_depth(d, n) for d, n in
            [(1, 8), (4, 8), (9, 8), (4, 0), (4, 1), (4, 3)]] == \
        [2, 4, 8, 2, 2, 3]
    with pytest.raises(TypeError):
        clamp_depth(2.0, 4)


def test_prefetch_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    before = build.launch_counts()
    src = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        prefetched_chain_copy([0], [1], src, torch.zeros((4, 8),
                                                         dtype=torch.int32))
    with pytest.raises(ValueError):
        prefetched_chain_copy([0], [1], src, torch.zeros((4, 9)))
    with pytest.raises(ValueError):
        prefetched_chain_copy([0, 1], [1], src, src.clone())
    with pytest.raises(IndexError):
        prefetched_chain_copy([4], [1], src, src.clone())
    with pytest.raises(TypeError):
        prefetched_chain_copy([0.5], [1], src, src.clone())
    with pytest.raises(ValueError):
        prefetched_chain_copy([0], [1], src, torch.zeros((4, 8), device="meta"))
    prefetched_chain_copy([0, 1], [2, 3], src, src.clone(), depth=4)
    prefetched_chain_copy_plain([0], [1], src, src.clone())
    assert build.launch_counts() == before


# ---------------------------------------------------------------------------
# translate_chain
# ---------------------------------------------------------------------------

def _tables():
    t, j = PageTable(16), JPageTable(16)
    for vp, slot in [(3, 11), (4, 9), (5, 2), (7, 3)]:
        t.remap(vp, 0, slot)
        j.remap(vp, 0, slot)
    return t, j


@pytest.mark.parametrize("translate_dst", [True, False])
def test_translate_chain_matches_jax_on_a_remapped_table(translate_dst):
    t, j = _tables()
    pages, row = [3, 4, 5, 7, 0], 8
    got = translate_chain(from_pages(pages, row, dst_base=16), t, row,
                          translate_dst=translate_dst)
    want = jtranslate(jfrom_pages(pages, row, dst_base=16), j, row,
                      translate_dst=translate_dst)
    for f in ("src", "dst", "length", "nxt", "config"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(np.asarray(got.src) // row,
                                  [11, 9, 2, 3, 0])


def test_translate_chain_splits_offsets_inside_a_page():
    t, j = _tables()
    from repro_torch.core.descriptor import DescriptorArray
    from repro.core.descriptor import DescriptorArray as JDescriptorArray
    src, dst, ln = [3 * 8 + 5, 4 * 8 + 1], [0, 7 * 8 + 7], [3, 1]
    got = translate_chain(DescriptorArray.create(src, dst, ln), t, 8)
    want = jtranslate(JDescriptorArray.create(src, dst, ln), j, 8)
    np.testing.assert_array_equal(np.asarray(got.src), np.asarray(want.src))
    np.testing.assert_array_equal(np.asarray(got.dst), np.asarray(want.dst))
    np.testing.assert_array_equal(np.asarray(got.src), [11 * 8 + 5,
                                                        9 * 8 + 1])


def test_translate_chain_refuses_pending_pages_like_jax():
    t, j = PageTable(8, 2), JPageTable(8, 2)
    t.flip_owner(2, 1)
    j.flip_owner(2, 1)
    with pytest.raises(RuntimeError, match="pending an ownership pull"):
        jtranslate(jfrom_pages([1, 2], 4), j, 4)
    with pytest.raises(RuntimeError, match="pending an ownership pull"):
        translate_chain(from_pages([1, 2], 4), t, 4)
    with pytest.raises(ValueError):
        translate_chain(from_pages([1], 4), t, 0)


@pytest.mark.parametrize("n", [1, 2, 4100])
def test_prefetch_table_route_model_matches_pallas(n):
    """The kernel's route (negative indices clamped to row 0 in the host
    pass, launches of at most MAX_TABLE, or 7, in stream order, the last
    write per launch) equals the Pallas kernel run in order."""
    rng = np.random.default_rng(40 + n)
    src, dst = _pools(rng, 96, 8, np.float32)
    sidx = rng.integers(-1, 96, n)
    didx = rng.integers(-1, min(max(n // 8, 2), 96), n)
    want = _j(sidx, didx, src, dst, 4)
    for cap in (None, 7):
        got = tref.table_copy_ref(sidx, didx, torch.from_numpy(src),
                                  torch.from_numpy(dst), clamp=True, cap=cap)
        np.testing.assert_array_equal(got.numpy(), want)
    launches = tref.table_launches(sidx, didx, clamp=True)
    assert sum(s.size for s, _ in launches) == n      # nothing is dropped
    assert all(s.min() >= 0 and d.min() >= 0 for s, d in launches)
