"""Hybrid multi-source batching (counterpart of
``visualbert_tpu/data/hybrid.py``; reference ``CustomBatchSampler``,
``unsupervised_visualbert/src/lxrt/h5_data.py:26-130``).

Each batch comes from ONE source (V&L, image-only, text-only), so each
source keeps its own tensor keys and shapes. The sources' batches are dealt
from a deck shuffled once an epoch, each source contributing its batch
count times its up- or down-sampling ratio; a source that runs out starts
again in a fresh order. The deck and every order are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

from visualbert_torch.data.pipeline import Batcher


class HybridBatcher:
    def __init__(self, batchers: Sequence[Batcher], upsample_ratios: Sequence[float] = None, seed: int = 0):
        self.batchers = list(batchers)
        self.upsample_ratios = list(upsample_ratios) if upsample_ratios else [1.0] * len(self.batchers)
        if len(self.upsample_ratios) != len(self.batchers):
            raise ValueError("one upsample ratio a source")
        self.seed = seed

    def counts(self):
        """Batches each source contributes an epoch."""
        return [max(int(round(b.num_batches() * r)), 0) for b, r in zip(self.batchers, self.upsample_ratios)]

    def deck(self, epoch: int) -> np.ndarray:
        """The epoch's source index of each batch, in order."""
        rng = np.random.default_rng((self.seed, epoch, 7))
        counts = self.counts()
        deck = (np.concatenate([np.full(c, i, np.int32) for i, c in enumerate(counts)]) if sum(counts)
                else np.zeros(0, np.int32))
        rng.shuffle(deck)
        return deck

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n_src = len(self.batchers)

        def cycle(b: Batcher, i: int):
            # a fresh order at each wrap of an upsampled source; the salt
            # keys (source, wrap) into a space apart from real epoch numbers
            # (< 2^20), so a wrap's order never repeats a later epoch's
            wrap = 0
            while True:
                salt = 0 if wrap == 0 else (1 << 20) + ((epoch * n_src + i) << 10) + wrap
                yield from b.epoch(epoch if wrap == 0 else salt)
                wrap += 1

        iters = [cycle(b, i) for i, b in enumerate(self.batchers)]
        for src in self.deck(epoch):
            yield next(iters[src])

    def num_batches(self) -> int:
        return sum(self.counts())

    def close(self):
        """Stop every source's worker threads."""
        for b in self.batchers:
            b.close()
