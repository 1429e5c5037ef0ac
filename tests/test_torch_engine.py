"""Port parity: the four engine tiers, bit for bit against the JAX package.

Seeded numpy pools and chains go through ``repro.core.engine`` and
``repro_torch.core.engine`` (CPU tensors). Outputs and done flags must be
identical, including ``execute_serial``'s window clamp near the pool tail
and the indices ``mode="drop"`` discards. Duplicate destinations have no
defined winner in XLA, so they are compared with JAX only where unique;
the port's own rule (last write wins) is checked against numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import descriptor as jdesc  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro_torch.core import descriptor as tdesc  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402


def _both(src, dst, length, nxt=None, config=None):
    return (jdesc.DescriptorArray.create(src, dst, length, nxt, config),
            tdesc.DescriptorArray.create(src, dst, length, nxt, config))


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def _pools(rng, n_src, n_dst, dtype=np.float32):
    return (rng.standard_normal(n_src).astype(dtype),
            rng.standard_normal(n_dst).astype(dtype))


def test_execute_chain_host_identical():
    rng = np.random.default_rng(0)
    src, dst = _pools(rng, 128, 128)
    jd, td = _both([0, 40, 90], [100, 0, 50], [20, 30, 10], nxt=[2, -1, 1])
    jo, jdd = jeng.execute_chain_host(jd, src, dst)
    to, tdd = teng.execute_chain_host(td, src, dst)
    np.testing.assert_array_equal(to, jo)
    _eq(tdd.done, jdd.done)
    _eq(tdd.length, jdd.length)


@pytest.mark.parametrize("case", ["middle", "tail_clamp", "sentinel_perm"])
def test_execute_serial_identical(case):
    rng = np.random.default_rng(1)
    src, dst = _pools(rng, 96, 80)
    max_len = 16
    if case == "middle":
        f = ([0, 20, 40, 3], [10, 12, 30, 50], [16, 5, 9, 16], None)
    elif case == "tail_clamp":
        # Windows starting within max_len of either pool's end are moved
        # back by dynamic_slice; the copy lands shifted, as in JAX.
        f = ([90, 85, 0], [75, 70, 78], [6, 11, 2], None)
    else:
        f = ([5, 60, 30, 70], [0, 40, 8, 64], [12, -1, 16, 9], [3, -1, 1, 2])
    jd, td = _both(*f)
    jo, jdone = jeng.execute_serial(jd, jnp.asarray(src), jnp.asarray(dst),
                                    max_len=max_len)
    s, d = torch.from_numpy(src.copy()), torch.from_numpy(dst.copy())
    to, tdone = teng.execute_serial(td, s, d, max_len=max_len)
    _eq(to, jo)
    _eq(tdone, jdone)
    np.testing.assert_array_equal(d.numpy(), dst)      # tiers are pure


@pytest.mark.parametrize("case", ["uniform", "short_and_sentinel",
                                  "dropped", "src_shorter"])
def test_execute_blocked_identical(case):
    rng = np.random.default_rng(2)
    unit = 8
    if case == "src_shorter":
        # Masked lanes target index len(src) with 0: inside a longer dst.
        src, dst = _pools(rng, 40, 64)
        f = ([0, 16, 32], [0, 8, 48], [8, 3, 5])
    else:
        src, dst = _pools(rng, 64, 64)
        f = {"uniform": ([0, 8, 24, 40], [56, 0, 16, 32], [8] * 4),
             "short_and_sentinel": ([3, 20, 41], [0, 30, 50], [5, -1, 8]),
             "dropped": ([0, 10], [60, 20], [8, 8])}[case]
    jd, td = _both(*f)
    jo, jdone = jeng.execute_blocked(jd, jnp.asarray(src), jnp.asarray(dst),
                                     unit=unit)
    to, tdone = teng.execute_blocked(td, torch.from_numpy(src),
                                     torch.from_numpy(dst), unit=unit)
    _eq(to, jo)
    _eq(tdone, jdone)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_execute_blocked_2d_identical(dtype):
    rng = np.random.default_rng(3)
    src = rng.integers(-50, 50, (12, 4, 3)).astype(dtype)
    dst = rng.integers(-50, 50, (10, 4, 3)).astype(dtype)
    # Unique destinations, a sentinel, an out-of-range destination (dropped)
    # and an out-of-range source (clipped).
    jd, td = _both([0, 5, 11, 2, 30], [9, 0, 4, 12, 7], [1, 1, -1, 1, 1])
    jo, jdone = jeng.execute_blocked_2d(jd, jnp.asarray(src),
                                        jnp.asarray(dst))
    to, tdone = teng.execute_blocked_2d(td, torch.from_numpy(src),
                                        torch.from_numpy(dst))
    _eq(to, jo)
    _eq(tdone, jdone)


def test_execute_blocked_2d_duplicates_last_write_wins():
    src = np.arange(6 * 4, dtype=np.float32).reshape(6, 4)
    dst = np.zeros((6, 4), np.float32)
    td = tdesc.DescriptorArray.create([0, 1, 2, 3], [5, 5, 2, 5],
                                      [1, 1, 1, -1])
    out, _ = teng.execute_blocked_2d(td, torch.from_numpy(src),
                                     torch.from_numpy(dst))
    want = dst.copy()
    want[2] = src[2]
    want[5] = src[1]            # the last *active* descriptor for row 5
    np.testing.assert_array_equal(out.numpy(), want)


def test_completion_events_identical():
    before = np.array([0, 0, 1, 0], np.int32)
    after = np.array([1, 0, 1, 1], np.int32)
    irq = np.array([1, 1, 1, 0], np.int32)
    want = jeng.completion_events(jnp.asarray(before), jnp.asarray(after),
                                  jnp.asarray(irq))
    got = teng.completion_events(torch.from_numpy(before),
                                 torch.from_numpy(after),
                                 torch.from_numpy(irq))
    _eq(got, want)
