"""Port parity: the synthetic data pipeline against the reference's
``repro.data``, bit for bit.

The port keeps its own numpy copy of the pipeline. For the same config and
step, ``make_batch`` must equal the reference's in every array, and the
packing chain (the port's ``DescriptorArray``) must equal the reference's
in every field; the iterator resumes mid-stream and hosts draw disjoint
streams, as in the reference's own tests (``tests/test_substrate.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro.data import pack_documents as jpack_documents  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig,
    DataIterator,
    IteratorState,
    make_batch,
    pack_documents,
)

CONFIGS = [dict(vocab_size=1000, seq_len=128, global_batch=4),
           dict(vocab_size=151936, seq_len=512, global_batch=4, seed=3),
           dict(vocab_size=512, seq_len=64, global_batch=8, mean_doc_len=16,
                num_hosts=2, host_id=1)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_make_batch_equals_reference(kw):
    for step in (0, 5):
        got, want = make_batch(DataConfig(**kw), step), \
            jmake_batch(JDataConfig(**kw), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", CONFIGS[::2])
def test_packing_chain_equals_reference(kw):
    got = pack_documents(DataConfig(**kw), np.random.default_rng(4), 3)
    want = jpack_documents(JDataConfig(**kw), np.random.default_rng(4), 3)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    for field in ("src", "dst", "length", "nxt", "config", "done"):
        a, b = getattr(got[2], field), getattr(want[2], field)
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=field)


def test_packing_descriptors_cover_sequences():
    cfg = DataConfig(vocab_size=1000, seq_len=128, global_batch=4)
    tokens, seg, chain = pack_documents(cfg, np.random.default_rng(0), 2)
    covered = np.zeros(2 * cfg.seq_len, bool)
    for dst, ln in zip(chain.dst.tolist(), chain.length.tolist()):
        assert not covered[dst:dst + ln].any()
        covered[dst:dst + ln] = True
    assert covered.all() and (seg > 0).all()


def test_hosts_disjoint_and_deterministic():
    kw = dict(vocab_size=1000, seq_len=128, global_batch=4, num_hosts=2)
    a = make_batch(DataConfig(host_id=0, **kw), 0)
    b = make_batch(DataConfig(host_id=1, **kw), 0)
    assert a["tokens"].shape == (2, 128)
    assert not np.array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(
        a["tokens"], make_batch(DataConfig(host_id=0, **kw), 0)["tokens"])


def test_iterator_resume_mid_stream():
    cfg = DataConfig(vocab_size=1000, seq_len=128, global_batch=4)
    it = DataIterator(cfg)
    first = [next(it) for _ in range(3)]
    state = IteratorState.from_dict(it.state.to_dict())
    it.close()
    assert state.step == 3
    it2 = DataIterator(cfg, state)
    b3 = next(it2)
    it2.close()
    np.testing.assert_array_equal(b3["tokens"], make_batch(cfg, 3)["tokens"])
    for i, b in enumerate(first):
        np.testing.assert_array_equal(b["labels"], make_batch(cfg, i)["labels"])
