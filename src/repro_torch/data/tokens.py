"""Fault-tolerant token pipeline, the port's copy of `repro.data.tokens`.

The epoch is split into chunks tracked by a `WorkJournal` (the
cluster-level Refresh, `runtime/journal.py`): a restarted or helping
worker re-serves only unfinished chunks, so a node failure never stalls
the batch stream and never silently drops data (the traversing property:
every chunk served at least once).

The data is synthetic and deterministic, seeded per chunk: chunk i
always yields the same tokens, drawn from the same
`numpy.random.default_rng((seed, i))` as repro's, which is what makes
helping idempotent.  Batches are int32 tensors on the pipeline's device.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.journal import WorkJournal


class TokenPipeline:
    """Yields (chunk_id, {"tokens", "labels"}) batches of (batch, seq_len)
    int32 tensors on `device` (None = CUDA; a CPU caller passes "cpu"),
    each label the next position's token and -1 at the last."""

    def __init__(self, *, vocab: int, batch: int, seq_len: int,
                 n_chunks: int = 128, batches_per_chunk: int = 4,
                 seed: int = 0, journal_path: Optional[str] = None,
                 worker: int = 0, device=None):
        from repro_torch.api import resolve_device
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.batches_per_chunk = batches_per_chunk
        self.seed = seed
        self.worker = worker
        self.device = resolve_device(device)
        self.journal = WorkJournal(journal_path, n_chunks)

    def _chunk_batches(self, chunk: int) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, chunk))
        for _ in range(self.batches_per_chunk):
            toks = rng.integers(0, self.vocab,
                                size=(self.batch, self.seq_len),
                                dtype=np.int32)
            labels = np.roll(toks, -1, axis=1)
            labels[:, -1] = -1                     # no target for last pos
            yield {"tokens": torch.from_numpy(toks).to(self.device),
                   "labels": torch.from_numpy(labels).to(self.device)}

    def __iter__(self) -> Iterator[Tuple[int, dict]]:
        """Yields (chunk_id, batch).  Owner phase, then helping phase."""
        while True:
            c = self.journal.acquire(self.worker)
            if c is None:
                break
            for b in self._chunk_batches(c):       # expeditive
                yield c, b
            self.journal.mark_done(c)
        # helping phase: steal unfinished parts past the backoff deadline
        while not self.journal.all_done():
            cands = self.journal.help_candidates()
            if not cands:
                time.sleep(self.journal.backoff_deadline())
                continue
            c = cands[0]
            self.journal.steal(c, self.worker)
            for b in self._chunk_batches(c):       # standard (idempotent)
                yield c, b
            self.journal.mark_done(c)
