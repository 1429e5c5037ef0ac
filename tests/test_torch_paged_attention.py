"""Port parity: paged decode attention, and the slice over the paged KV cache.

On the CPU the wrapper runs its plain PyTorch version; the Pallas kernel
runs in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_substrate.py`` run it. Tolerances are those of
``tests/test_kernels.py``: rtol = atol = 2e-5 in float32 and 2e-2 in
bfloat16 (the sums run in another order). ``tests/test_torch_cuda.py``
holds the CUDA kernel against the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as jpaged,
)
from repro.kernels.prefetch_pipeline import (  # noqa: E402
    prefetched_chain_copy as jprefetch,
)
from repro.runtime.lowering import (  # noqa: E402
    translate_chain as jtranslate,
)
from repro.serve.kv_cache import PagedKVCache as JCache  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
)
from repro_torch.runtime.lowering import translate_chain  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _inputs(rng, b, h, kv, d, page, pool, maxp, lengths, holes=()):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((pool, page, kv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, kv, d)).astype(np.float32)
    tables = rng.choice(pool, size=(b, maxp), replace=False).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    tables = np.where(np.arange(maxp)[None, :] * page < lengths[:, None],
                      tables, -1).astype(np.int32)
    for bi, p in holes:                       # -1 inside the length
        tables[bi, p] = -1
    return q, kp, vp, tables, lengths


def _jax(q, kp, vp, tables, lengths, dtype):
    return np.asarray(jpaged(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
                             jnp.asarray(vp, dtype), jnp.asarray(tables),
                             jnp.asarray(lengths), interpret=True
                             ).astype(jnp.float32))


def _torch(q, kp, vp, tables, lengths, dtype, fn=paged_attention):
    t = lambda x: torch.from_numpy(x).to(dtype)           # noqa: E731
    return fn(t(q), t(kp), t(vp), torch.from_numpy(tables),
              torch.from_numpy(lengths)).float().numpy()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (5, 1)])
def test_paged_attention_plain_matches_pallas(dtype, h, kv):
    rng = np.random.default_rng(h * 10 + kv)
    page, maxp = 8, 4
    q, kp, vp, tables, lengths = _inputs(
        rng, 4, h, kv, 64, page, 20, maxp,
        [maxp * page, 2 * page + 5, 7, 3 * page + 1], holes=[(0, 1)])
    jd = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    td = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = _jax(q, kp, vp, tables, lengths, jd)
    got = _torch(q, kp, vp, tables, lengths, td)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_paged_attention_length_zero_gives_zeros_like_the_kernel():
    """A row with no valid token: zeros (the kernel), not the uniform
    average of V that the JAX package's reference gives."""
    rng = np.random.default_rng(3)
    q, kp, vp, tables, lengths = _inputs(rng, 3, 4, 2, 32, 4, 12, 3,
                                         [0, 9, 5], holes=[(2, 0),
                                                           (2, 1)])
    want = _jax(q, kp, vp, tables, lengths, jnp.float32)
    got = _torch(q, kp, vp, tables, lengths, torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert not got[0].any() and not got[2].any()     # len 0; all pages -1
    ref = _torch(q, kp, vp, tables, lengths, torch.float32,
                 fn=tref.paged_attention_ref)
    np.testing.assert_array_equal(ref, got)


def test_paged_attention_ignores_entries_past_the_length():
    """Entries past ceil(len / page) are never read, whatever they hold."""
    rng = np.random.default_rng(4)
    q, kp, vp, tables, lengths = _inputs(rng, 2, 4, 2, 16, 4, 16, 4, [5, 9])
    base = _torch(q, kp, vp, tables, lengths, torch.float32)
    tables[0, 2:] = [7, 11]
    tables[1, 3] = 0
    np.testing.assert_array_equal(
        _torch(q, kp, vp, tables, lengths, torch.float32), base)


def test_paged_attention_plain_matches_the_jax_reference_when_nonempty():
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    q, kp, vp, tables, lengths = _inputs(rng, 3, 6, 3, 32, 4, 16, 4,
                                         [13, 4, 16])
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths)))
    got = _torch(q, kp, vp, tables, lengths, torch.float32,
                 fn=paged_attention_plain)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_wrapper_rejects_bad_inputs():
    q = torch.zeros((2, 4, 8))
    kp = torch.zeros((6, 4, 2, 8))
    tables = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.zeros((2,), dtype=torch.int32)
    before = build.launch_counts()
    paged_attention(q, kp, kp, tables, lengths)
    assert build.launch_counts() == before           # CPU: no launch
    bad = [
        (TypeError, (q, kp, kp, tables.long(), lengths)),
        (TypeError, (q, kp, kp, tables, lengths.long())),
        (TypeError, (q.half(), kp.half(), kp.half(), tables, lengths)),
        (TypeError, (q, kp.bfloat16(), kp, tables, lengths)),
        (ValueError, (q[:, :3], kp, kp, tables, lengths)),        # H % KV
        (ValueError, (torch.zeros((2, 18, 8)), kp, kp, tables, lengths)),
        (ValueError, (torch.zeros((2, 4, 6)), torch.zeros((6, 4, 2, 6)),
                      torch.zeros((6, 4, 2, 6)), tables, lengths)),  # D % 4
        (ValueError, (q, kp, kp[:5], tables, lengths)),
        (ValueError, (q, kp, kp, tables[:1], lengths)),
        (ValueError, (q, kp, kp, tables, lengths.to("meta"))),
        (TypeError, (q, kp, kp, tables.numpy(), lengths)),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            paged_attention(*args)


def test_paged_attention_op_matches_pallas_op_over_cache_args():
    """The entry point over the port's cache, against the JAX cache and
    ``repro.kernels.ops.paged_attention_op`` on the same tokens."""
    t, j, q = _twin_caches(np.random.default_rng(8))
    got = ops.paged_attention_op(torch.from_numpy(q), *t.kernel_args())
    want = np.asarray(jops.paged_attention_op(jnp.asarray(q),
                                              *j.kernel_args()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    args = t.kernel_args()
    assert [a.dtype for a in args[2:]] == [torch.int32, torch.int32]
    assert all(a.device == t.device for a in args)


# ---------------------------------------------------------------------------
# The slice: decode over pages that move, remap and swap, in both packages
# ---------------------------------------------------------------------------

PAGE, KVH, D, H, NUM_PAGES, SEQS, MAXP = 4, 2, 8, 4, 32, 3, 4
ROW = PAGE * KVH * D


def _twin_caches(rng, lengths=(13, 9, 16)):
    geom = dict(page=PAGE, num_pages=NUM_PAGES, max_seqs=SEQS,
                max_pages_per_seq=MAXP, kv_heads=KVH, head_dim=D)
    t = PagedKVCache(**geom, dtype=torch.float32, device="cpu")
    j = JCache(**geom)
    for s in range(SEQS):
        t.admit(s)
        j.admit(s)
    for step in range(max(lengths)):               # interleaved growth
        for s in range(SEQS):
            if step < lengths[s]:
                k = rng.standard_normal((KVH, D)).astype(np.float32)
                v = rng.standard_normal((KVH, D)).astype(np.float32)
                t.append(s, k, v)
                j.append(s, jnp.asarray(k), jnp.asarray(v))
    q = rng.standard_normal((SEQS, H, D)).astype(np.float32)
    return t, j, q


def _decode(t, j, q):
    got = ops.paged_attention_op(torch.from_numpy(q), *t.kernel_args())
    want = np.asarray(jops.paged_attention_op(jnp.asarray(q),
                                              *j.kernel_args()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    return got


def _swap_rows(cache, seqs, translate):
    """(hot rows, cold rows) of ``seqs``' chains, lowered physically."""
    hot, cold = [], []
    for n, s in enumerate(seqs):
        phys = translate(cache.chain(s), cache.page_table, ROW,
                         translate_dst=False)
        hot.append(np.asarray(phys.src, np.int64) // ROW)
        cold.append(n * MAXP + np.asarray(phys.dst, np.int64) // ROW)
    return np.concatenate(hot), np.concatenate(cold)


def test_slice_decode_over_remap_and_prefetched_swap_matches_jax():
    t, j, q = _twin_caches(np.random.default_rng(11))
    o0 = _decode(t, j, q)

    # Remap-defragment a fragmented sequence: tables change, decode not.
    rate_t = t.defragment(1, mode="remap")
    rate_j = j.defragment(1, mode="remap")
    assert rate_t == rate_j and rate_t > 0.0
    np.testing.assert_array_equal(t.tables, j.tables)
    assert torch.equal(_decode(t, j, q), o0)

    # §II-C swap-out of sequences 0 and 1 through translate_chain and the
    # prefetched chain copy, into cold pools.
    seqs = [0, 1]
    hot, cold = _swap_rows(t, seqs, translate_chain)
    jhot, jcold = _swap_rows(j, seqs, jtranslate)
    np.testing.assert_array_equal(hot, jhot)
    np.testing.assert_array_equal(cold, jcold)
    kt, vt = t.k_pages.view(NUM_PAGES, ROW), t.v_pages.view(NUM_PAGES, ROW)
    cold_t = [torch.zeros((len(seqs) * MAXP, ROW)) for _ in range(2)]
    for pool, c in zip((kt, vt), cold_t):
        ops.prefetched_chain_copy_op(hot, cold, pool, c)
    cold_j = [jprefetch(jnp.asarray(jhot, jnp.int32),
                        jnp.asarray(jcold, jnp.int32),
                        pool.reshape(NUM_PAGES, ROW),
                        jnp.zeros((len(seqs) * MAXP, ROW)), depth=4,
                        interpret=True)
              for pool in (j.k_pages, j.v_pages)]
    for a, b in zip(cold_t, cold_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for n, s in enumerate(seqs):
        k, v = t.dense_view(s)
        ln = len(k)
        rows = cold_t[0][n * MAXP:(n + 1) * MAXP].reshape(-1, KVH, D)[:ln]
        np.testing.assert_array_equal(rows.numpy(), k)
        rows = cold_t[1][n * MAXP:(n + 1) * MAXP].reshape(-1, KVH, D)[:ln]
        np.testing.assert_array_equal(rows.numpy(), v)

    # Evict the hot pages: decode must change, in both packages alike.
    kt[hot] = 0
    vt[hot] = 0
    j.k_pages = j.k_pages.reshape(NUM_PAGES, ROW).at[jhot].set(0).reshape(
        j.k_pages.shape)
    j.v_pages = j.v_pages.reshape(NUM_PAGES, ROW).at[jhot].set(0).reshape(
        j.v_pages.shape)
    assert not torch.equal(_decode(t, j, q), o0)

    # Swap-in: back through the prefetched copy; decode is o0 again.
    for pool, c in zip((kt, vt), cold_t):
        ops.prefetched_chain_copy_op(cold, hot, c, pool)
    j.k_pages, j.v_pages = [
        jprefetch(jnp.asarray(jcold, jnp.int32), jnp.asarray(jhot, jnp.int32),
                  c, pool.reshape(NUM_PAGES, ROW), depth=4,
                  interpret=True).reshape(pool.shape)
        for pool, c in zip((j.k_pages, j.v_pages), cold_j)]
    assert torch.equal(_decode(t, j, q), o0)
