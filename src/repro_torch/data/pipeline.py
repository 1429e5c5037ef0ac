"""Synthetic data pipeline: deterministic corpus, descriptor-chain packing,
prefetching, and checkpointable iterator state.

The sequence-packing map (which document spans land where in each fixed-size
training sequence) is emitted as a descriptor chain (the port's
:func:`repro_torch.core.chain.from_segments`) beside the packed batch: the
data path is a consumer of the paper's mechanism (DESIGN.md §3). Batches are
numpy arrays, the same as the reference's bit for bit for the same config
and step; the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.chain import from_segments
from repro_torch.core.descriptor import DescriptorArray


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    num_hosts: int = 1
    host_id: int = 0
    prefetch_depth: int = 2


@dataclasses.dataclass
class IteratorState:
    """Checkpointable position: (step, rng counter). Restoring reproduces the
    exact upcoming batch stream."""
    step: int = 0

    def to_dict(self) -> Dict:
        return {"step": self.step}

    @staticmethod
    def from_dict(d: Dict) -> "IteratorState":
        return IteratorState(step=int(d["step"]))


def mesh_hosts(mesh) -> Tuple[int, int]:
    """``(host_id, num_hosts)`` of this rank on a process mesh: its
    position along the batch axes (``pod``, ``data``) and their size. The
    ``model`` axis does not count: ranks along it take the same rows. (The
    reference reads ``jax.process_index()``, a host there driving many
    chips; here a process is a mesh position.)"""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return mesh.index(axes), mesh.size(axes)


def _doc_stream(cfg: DataConfig, step: int) -> np.random.Generator:
    # Counter-based: host and step fully determine the stream (restartable,
    # disjoint across hosts).
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.host_id, step]))


def pack_documents(cfg: DataConfig, rng: np.random.Generator,
                   batch_rows: int) -> Tuple[np.ndarray, np.ndarray,
                                             DescriptorArray]:
    """Draw documents and pack them into (rows, seq_len) via descriptors.

    Returns (tokens, segment_ids, packing_chain). Document boundaries insert
    an EOS-like separator (token 0); segment_ids let attention variants mask
    across documents if desired.
    """
    rows, s = batch_rows, cfg.seq_len
    tokens = np.zeros((rows, s), np.int32)
    seg = np.zeros((rows, s), np.int32)
    srcs, dsts, lens = [], [], []
    flat_docs = []
    cursor = 0
    for r in range(rows):
        filled = 0
        seg_id = 1
        while filled < s:
            doc_len = int(rng.integers(cfg.mean_doc_len // 4,
                                       cfg.mean_doc_len * 2))
            doc_len = min(doc_len, s - filled)
            # Learnable synthetic text: a noisy affine recurrence, so models
            # have real structure to fit (pure uniform tokens would pin the
            # loss at ln(V) and make convergence tests meaningless).
            v = cfg.vocab_size - 1
            doc = np.empty(doc_len, np.int32)
            doc[0] = rng.integers(1, cfg.vocab_size)
            noise = rng.random(doc_len) < 0.15
            rand = rng.integers(1, cfg.vocab_size, doc_len, dtype=np.int32)
            for i in range(1, doc_len):
                doc[i] = rand[i] if noise[i] else \
                    (doc[i - 1] * 31 + 17) % v + 1
            flat_docs.append(doc)
            srcs.append(cursor)
            dsts.append(r * s + filled)
            lens.append(doc_len)
            tokens[r, filled:filled + doc_len] = doc
            seg[r, filled:filled + doc_len] = seg_id
            cursor += doc_len
            filled += doc_len
            seg_id += 1
    chain = from_segments(np.asarray(srcs), np.asarray(dsts),
                          np.asarray(lens))
    return tokens, seg, chain


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = _doc_stream(cfg, step)
    rows = cfg.global_batch // cfg.num_hosts
    tokens, seg, chain = pack_documents(cfg, rng, rows)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    mask = (labels != 0).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "loss_mask": mask,
            "segment_ids": seg}


class DataIterator:
    """Prefetching, restartable iterator over synthetic packed batches."""

    def __init__(self, cfg: DataConfig, state: Optional[IteratorState] = None):
        self.cfg = cfg
        self.state = state or IteratorState()
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch_depth)
        self._stop = threading.Event()
        self._next_to_produce = self.state.step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            step = self._next_to_produce
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._next_to_produce += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        assert step == self.state.step, "prefetch stream out of sync"
        self.state.step += 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
