"""Deterministic, resumable, sharded token pipeline.

A copy of the JAX package's pipeline (numpy only): ``batch(step)`` gives
the JAX package's arrays bit for bit (the same seed mixing, EOS = 0), and
``to_device`` moves a batch onto a torch device as int32 tensors.

Production constraints honoured:
  * deterministic as a function of (seed, step) — a restore at step k
    replays exactly the batch stream from step k (bitwise resume);
  * per-host sharding — each host generates only its slice of the global
    batch (no host materialises the global array at scale);
  * background prefetch with bounded queue (overlaps host data work with
    device steps);
  * document-pack synthetic corpus by default (zipf token distribution,
    EOS-delimited docs) or memory-mapped token files.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

EOS = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    #: synthetic | file
    source: str = "synthetic"
    path: Optional[str] = None
    #: this host's slice (host_index, host_count)
    host_index: int = 0
    host_count: int = 1
    #: zipf exponent for the synthetic corpus
    zipf_a: float = 1.3
    mean_doc_len: int = 512

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count


class TokenSource:
    """Step-indexed batch generator: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._file_tokens: Optional[np.ndarray] = None
        if cfg.source == "file":
            if not cfg.path:
                raise ValueError("file source requires path")
            self._file_tokens = np.memmap(cfg.path, dtype=np.int32,
                                          mode="r")

    def _rng(self, step: int, row: int) -> np.random.Generator:
        c = self.cfg
        seed = (np.uint64(c.seed) * np.uint64(0x9E3779B97F4A7C15)
                + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
                + np.uint64(c.host_index * c.host_batch + row))
        return np.random.default_rng(np.uint64(seed))

    def _synthetic_row(self, step: int, row: int) -> np.ndarray:
        c = self.cfg
        rng = self._rng(step, row)
        out = np.empty(c.seq_len + 1, np.int32)
        i = 0
        while i < c.seq_len + 1:
            dlen = int(rng.exponential(c.mean_doc_len)) + 8
            doc = rng.zipf(c.zipf_a, size=dlen).astype(np.int64)
            doc = (doc % (c.vocab_size - 1)) + 1          # reserve EOS=0
            n = min(dlen, c.seq_len + 1 - i)
            out[i:i + n] = doc[:n]
            i += n
            if i < c.seq_len + 1:
                out[i] = EOS
                i += 1
        return out

    def _file_row(self, step: int, row: int) -> np.ndarray:
        c = self.cfg
        total = self._file_tokens.shape[0] - (c.seq_len + 1)
        rng = self._rng(step, row)
        start = int(rng.integers(0, total))
        return np.asarray(self._file_tokens[start:start + c.seq_len + 1],
                          np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Host-local slice of the global batch for ``step``."""
        c = self.cfg
        make = self._file_row if c.source == "file" else self._synthetic_row
        rows = np.stack([make(step, r) for r in range(c.host_batch)])
        return {"tokens": rows[:, :-1],
                "labels": rows[:, 1:].astype(np.int32)}


class Prefetcher:
    """Bounded background prefetch of step-indexed batches."""

    def __init__(self, source: TokenSource, start_step: int = 0,
                 depth: int = 2):
        self._source = source
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch(step)
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                return self._queue.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                continue

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def to_device(batch: Dict[str, np.ndarray],
              device: "torch.device | str") -> Dict[str, torch.Tensor]:
    """A host batch as torch tensors on ``device`` (int32 tokens and
    labels stay int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
