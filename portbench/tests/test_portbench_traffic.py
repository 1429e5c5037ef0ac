"""The generator: each mix's inputs are a function of the seed alone and
follow the mix's law."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.harness import core, traffic

MIXES = {p.stem: json.loads(p.read_text())
         for p in sorted((core.BENCH / "traffic").glob("*.json"))}
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("name", [n for n, m in MIXES.items()
                                  if m["kind"] == "train"])
def test_train_batches_are_the_seeds(name):
    mix = dict(MIXES[name], rows=2, seq_len=64)
    mix["microbatches"] = min(mix["microbatches"], 2)
    a = traffic.TrainFeed(mix, 1000, BIG, torch.device("cpu"))
    b = traffic.TrainFeed(mix, 1000, BIG, torch.device("cpu"))
    c = traffic.TrainFeed(mix, 1000, BIG + 1, torch.device("cpu"))
    for i in range(3):
        x, y = a.batch(i), b.batch(i)
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
        assert int(x["tokens"].max()) < 1000
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    assert not torch.equal(a.batch(0)["tokens"], c.batch(0)["tokens"])
    mbs = a.microbatches(1)
    assert torch.equal(torch.cat([m["tokens"] for m in mbs]),
                       a.batch(1)["tokens"])


def test_ids_are_the_first_whose_cumulative_probability_passes_the_draw():
    """Ids follow the mix's law: the draws at fixed uniforms land where the
    float64 cumulative sum says, and a large batch's frequencies follow
    the probabilities."""
    mix = dict(MIXES["pretrain_4k"], rows=4, seq_len=4095)
    feed = traffic.TrainFeed(mix, 50, BIG, torch.device("cpu"))
    p = traffic.token_probs(mix["tokens"], 50, BIG)
    cdf = np.cumsum(p) / p.sum()
    u = torch.tensor([0.0, cdf[0], cdf[7] - 1e-12, cdf[7], 1 - 1e-16],
                     dtype=torch.float64)
    ids = torch.searchsorted(feed.cdf, u, right=True).tolist()
    assert ids == [0, 1, 7, 8, 49]
    ids = feed.batch(0)["tokens"].flatten()
    freq = torch.bincount(ids, minlength=50).double() / ids.numel()
    assert torch.allclose(freq, torch.tensor(p), atol=0.01)


def test_zipf_ids_cover_and_follow_the_law():
    p = traffic.token_probs({"distribution": "zipf", "exponent": 1.1},
                            1000, 3)
    assert np.isclose(p.sum(), 1.0) and (p > 0).all()
    top = np.sort(p)[::-1]
    assert np.isclose(top[0] / top[1], 2 ** 1.1)
