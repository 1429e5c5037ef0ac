"""Port parity: descriptors, chains, signatures, coalescer and kv8 (CPU).

The same seeded numpy inputs go through the JAX package (``repro``) and
the PyTorch port (``repro_torch``). Packed descriptor bytes, chain walks,
``ChainSignature``s and their blake2b digests, and coalescer plans must be
identical. The kv_int8 round trip must agree with JAX's jitted
``kv8_roundtrip`` within one quantisation step (the tolerance of
``tests/test_transform.py``) and be exact against the reference's numpy
oracle ``kv8_roundtrip_np``: XLA on the CPU itself strays from that oracle
by up to one ulp for some shapes (a flat (512,) input), the port does not.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import chain as jchain  # noqa: E402
from repro.core import descriptor as jdesc  # noqa: E402
from repro.core import signature as jsig  # noqa: E402
from repro.core import transform as jtr  # noqa: E402
from repro.runtime.coalesce import coalesce as jcoalesce  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
from repro_torch.core import descriptor as tdesc  # noqa: E402
from repro_torch.core import signature as tsig  # noqa: E402
from repro_torch.core import transform as ttr  # noqa: E402
from repro_torch.runtime.coalesce import coalesce as tcoalesce  # noqa: E402


def _fields(rng, n, *, permute=False):
    src = rng.integers(0, 1 << 20, n)
    dst = rng.integers(0, 1 << 20, n)
    length = rng.integers(1, 512, n)
    config = rng.integers(0, 4, n)
    nxt = None
    if permute:
        order = rng.permutation(n)
        nxt = np.full(n, -1, np.int64)
        nxt[order[:-1]] = order[1:]
    return src, dst, length, nxt, config


def _both(src, dst, length, nxt=None, config=None):
    return (jdesc.DescriptorArray.create(src, dst, length, nxt, config),
            tdesc.DescriptorArray.create(src, dst, length, nxt, config))


def _chains(seed):
    """A spread of chain shapes: sequential, strided, gather, permuted."""
    rng = np.random.default_rng(seed)
    out = [_both(*_fields(rng, 7)),
           _both(*_fields(rng, 9, permute=True))]
    out.append((jchain.from_strided_2d(64, 4096, 32, 6, 48, 32),
                tchain.from_strided_2d(64, 4096, 32, 6, 48, 32)))
    pages = rng.permutation(16)[:5]
    out.append((jchain.from_pages(pages, 256), tchain.from_pages(pages, 256)))
    segs = np.arange(8) * 16
    out.append((jchain.from_segments(segs, segs + 1024, np.full(8, 16)),
                tchain.from_segments(segs, segs + 1024, np.full(8, 16))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_bytes_identical(seed):
    rng = np.random.default_rng(seed)
    f = _fields(rng, 11, permute=seed == 1)
    jd, td = _both(*f)
    done = rng.choice(11, 3, replace=False)
    jd, td = jd.mark_done(done.astype(np.int32)), td.mark_done(done)
    for kw in ({}, {"elem_bytes": 4, "src_base": 4096, "dst_base": 1 << 30,
                    "table_base": 0x1000}):
        jp, tp = jdesc.to_packed(jd, **kw), tdesc.to_packed(td, **kw)
        assert tdesc.to_bytes(tp) == jdesc.to_bytes(jp)
        back = tdesc.from_packed(tp, **kw)
        jback = jdesc.from_packed(jp, **kw)
        for name in ("src", "dst", "length", "nxt", "config", "done"):
            got = getattr(back, name)
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jback, name)))


def test_descriptor_array_is_int32_host_state():
    d = tdesc.DescriptorArray.create(np.array([1, 2], np.int64), [3, 4], [5, 6])
    for name in ("src", "dst", "length", "nxt", "config", "done"):
        t = getattr(d, name)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
    assert d.nxt.tolist() == [1, -1]
    dd = d.mark_done([1])
    assert dd.done.tolist() == [0, 1] and dd.length.tolist() == [5, -1]
    assert d.done.tolist() == [0, 0]          # the original is untouched
    assert not d.all_done() and dd.mark_done([0]).all_done()


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_walks_and_flatten_identical(seed):
    for jd, td in _chains(seed):
        assert tchain.walk_chain_host(td) == jchain.walk_chain_host(jd)
        jp, jc = jchain.flatten_chain(jd.nxt, 0)
        tp, tc = tchain.flatten_chain(td.nxt, 0)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert int(tc) == int(jc)
        jt, jh = jchain.plan_sequential_layout(jd)
        tt, th = tchain.plan_sequential_layout(td)
        assert tdesc.to_bytes(tt) == jdesc.to_bytes(jt) and th == jh


def test_concat_chains_identical():
    rng = np.random.default_rng(5)
    pairs = [_both(*_fields(rng, n)) for n in (3, 4, 2)]
    jc = jchain.concat_chains([p[0] for p in pairs])
    tc = tchain.concat_chains([p[1] for p in pairs])
    assert tdesc.to_bytes(tdesc.to_packed(tc)) == \
        jdesc.to_bytes(jdesc.to_packed(jc))


@pytest.mark.parametrize("seed", [0, 1])
def test_signatures_and_digests_identical(seed):
    for jd, td in _chains(seed):
        jcan, tcan = jsig.canonicalize(jd), tsig.canonicalize(td)
        assert tcan.digest == jcan.digest
        for tier, depth, token in (("serial", 0, ""), ("blocked", 4, "kv8")):
            js = jsig.signature_of(jcan, tier=tier, depth=depth,
                                   transform=token)
            ts = tsig.signature_of(tcan, tier=tier, depth=depth,
                                   transform=token)
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)


@pytest.mark.parametrize("allow_merge", [True, False])
def test_coalescer_plans_identical(allow_merge):
    segs = np.array([0, 16, 32, 100, 116, 400], np.int64)
    lens = np.array([16, 16, 40, 16, 16, 300], np.int64)
    cfg = np.array([0, 0, 0, 1, 0, 0], np.int64)
    jd, td = _both(segs, segs + 2048, lens, None, cfg)
    jp, js = jcoalesce(jd, max_len=64, spec_depth=2, allow_merge=allow_merge)
    tp, ts = tcoalesce(td, max_len=64, spec_depth=2, allow_merge=allow_merge)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert tdesc.to_bytes(tdesc.to_packed(tp)) == \
        jdesc.to_bytes(jdesc.to_packed(jp))


@pytest.mark.parametrize("shape", [(2, 8, 16), (3, 100), (512,)])
def test_kv8_roundtrip_within_one_step_and_exact(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:7] = 0.0                          # a partly zero block
    want = np.asarray(jtr.kv8_roundtrip(jnp.asarray(x)))
    got = ttr.kv8_roundtrip(torch.from_numpy(x)).numpy()
    step = float(np.abs(x).max()) / 127.0             # >= every block scale
    assert got.shape == x.shape and got.dtype == x.dtype
    assert float(np.max(np.abs(got - want))) <= step   # stated tolerance
    np.testing.assert_array_equal(got, jtr.kv8_roundtrip_np(x))  # exact


def test_transform_specs_and_reference_apply_identical():
    rng = np.random.default_rng(9)
    src = rng.standard_normal(512).astype(np.float32)
    dst = rng.standard_normal(512).astype(np.float32)
    segs = np.array([0, 64, 256], np.int64)
    jd, td = _both(segs, segs[::-1] + 8, np.array([32, 64, 16]))
    for name in ("identity", "kv_int8", "reduce_sum"):
        js, ts = jtr.as_transform(name), ttr.as_transform(name)
        assert (ts.cache_token, ts.merge_safe, ts.payload_ratio) == \
            (js.cache_token, js.merge_safe, js.payload_ratio)
        np.testing.assert_array_equal(
            ttr.reference_apply(ts, td, torch.from_numpy(src), dst),
            jtr.reference_apply(js, jd, src, dst))
    js, ts = jtr.TransformSpec.transpose(16, 32), \
        ttr.TransformSpec.transpose(16, 32)
    assert ts.cache_token == js.cache_token
    np.testing.assert_array_equal(
        ttr.transform_source_view(ts, torch.from_numpy(src)).numpy(),
        np.asarray(jtr.transform_source_view(js, jnp.asarray(src))))
