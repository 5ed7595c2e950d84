"""Host-side batching with static shapes (a copy of
``case_rg_tpu/data/batching.py``).

Replaces the reference's DataLoader + DistributedSampler combination
(common/CumulativeTrainer.py:88-95,134-142):

* per-epoch seeded permutation (reference: ``sampler.set_epoch(epoch)``);
* per-process sharding by ``(process_index, process_count)``; with more
  than one process every rank's rows are padded to ``ceil(n / count)``
  with duplicates of weight 0, so the ranks step in lockstep (the same
  batch count on each: a data-parallel step is a collective). One process
  batches exactly as the JAX copy does;
* the final partial batch is padded with duplicate rows and flagged with a
  ``sample_weight`` vector so every batch has the same static shape (losses
  consume the weights; the reference instead shipped a smaller last batch);
* the per-access random gold-passage pick (CaSEDataset.py:111-113) becomes a
  deterministic per-epoch draw from the stored gold-index list.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


def select_gold(passage_labels: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """passage_labels: [N, G] with -1 padding -> [N] one gold index each."""
    n, g = passage_labels.shape
    counts = (passage_labels >= 0).sum(axis=1).clip(min=1)
    choice = rng.randint(0, 1 << 30, size=n) % counts
    return passage_labels[np.arange(n), choice].clip(min=0).astype(np.int32)


class Batcher:
    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 pad_final: bool = True):
        self.arrays = arrays
        self.n = len(arrays["id"])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.pad_final = pad_final

    def _shuffled(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState((self.seed + epoch) % (1 << 31))
            rng.shuffle(idx)
        return idx

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = self._shuffled(epoch)
        # round-robin shard per process (DistributedSampler-style interleave;
        # per-rank result shards carry their own sample indices, so the eval
        # merge does not depend on shard layout)
        return idx[self.process_index::self.process_count]

    def _rank_rows(self, epoch: int):
        """(this rank's row indices, how many of them are real): with more
        than one process the list is padded to ceil(n / count) rows by
        repeating its last row (row 0 of the epoch where it has none)."""
        idx = self._epoch_indices(epoch)
        real = len(idx)
        if self.process_count > 1:
            m = -(-self.n // self.process_count)
            if real < m:
                fill = idx[-1:] if real else self._shuffled(epoch)[:1]
                idx = np.concatenate([idx, np.repeat(fill, m - real)])
        return idx, real

    def num_batches(self, epoch: int = 0) -> int:
        n = len(self._rank_rows(epoch)[0])
        if self.pad_final:
            return -(-n // self.batch_size)
        return n // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx, n_real = self._rank_rows(epoch)
        rng = np.random.RandomState((self.seed * 31 + epoch) % (1 << 31))
        gold = None
        if "passage_labels" in self.arrays:
            gold = select_gold(self.arrays["passage_labels"], rng)
        bs = self.batch_size
        for start in range(0, len(idx), bs):
            chunk = idx[start:start + bs]
            real = min(len(chunk), max(n_real - start, 0))
            if len(chunk) < bs:
                if not self.pad_final:
                    break
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:],
                                                         bs - len(chunk))])
            batch = {k: v[chunk] for k, v in self.arrays.items()
                     if k != "passage_labels"}
            if gold is not None:
                batch["passage_label"] = gold[chunk]
            w = np.zeros(bs, np.float32)
            w[:real] = 1.0
            batch["sample_weight"] = w
            batch["_indices"] = chunk  # host-side bookkeeping, stripped pre-jit
            yield batch
