"""The one generator of traffic: it reads a mix's parameters (a data file
under ``traffic/``) and makes its inputs from the run's seed. The program
is handed only the tokens made here.

Training mixes (``kind`` "train"): each optimizer step's rows of token
ids, drawn on the device from (seed, step), with their next-token labels;
``microbatches`` slices of ``rows`` rows of ``seq_len`` tokens. An id is
the first whose cumulative probability (summed once on the host, in
float64) exceeds a uniform draw, so the same seed gives the same ids to
the bit however often a step's batch is drawn again: the program and the
reference each draw it. (``torch.multinomial`` on the card sums its
float32 cumulative distribution in another order from call to call, and
gives a few ids of a large batch differently.)
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .weights import derive_seed


def token_probs(spec: dict, vocab: int, seed: int) -> np.ndarray:
    """Probabilities of the ids 0..vocab-1: Zipf's law over the ranks
    (rank r has weight (r + 1) ** -exponent), the ranks dealt to ids in an
    order drawn from the seed."""
    assert spec["distribution"] == "zipf", spec
    w = (np.arange(vocab) + 1.0) ** -float(spec["exponent"])
    perm = np.random.default_rng(derive_seed(seed, "token_ranks")).permutation(
        vocab)
    p = np.empty(vocab)
    p[perm] = w / w.sum()
    return p


class TrainFeed:
    """The batches of a training mix: ``batch(i)`` is step i's dict of
    ``tokens`` and ``labels`` (rows, seq_len) int64 on ``device``."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.mix, self.seed, self.device = mix, seed, device
        cdf = np.cumsum(token_probs(mix["tokens"], vocab, seed))
        self.cdf = torch.tensor(cdf / cdf[-1], dtype=torch.float64,
                                device=device)

    @property
    def tokens_per_step(self) -> int:
        return self.mix["rows"] * self.mix["seq_len"]

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        rows, s = self.mix["rows"], self.mix["seq_len"]
        gen = torch.Generator(device=self.device).manual_seed(
            derive_seed(self.seed, "batch", i))
        u = torch.rand(rows * (s + 1), generator=gen, dtype=torch.float64,
                       device=self.device)
        ids = torch.searchsorted(self.cdf, u, right=True).clamp_(
            max=len(self.cdf) - 1).view(rows, s + 1)
        return {"tokens": ids[:, :-1].contiguous(),
                "labels": ids[:, 1:].contiguous()}

    def microbatches(self, i: int) -> List[Dict[str, torch.Tensor]]:
        """Step i's batch cut into the mix's microbatches, in order."""
        b = self.batch(i)
        n = self.mix["microbatches"]
        per = self.mix["rows"] // n
        return [{k: v[j * per:(j + 1) * per] for k, v in b.items()}
                for j in range(n)]
