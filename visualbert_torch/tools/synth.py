"""Synthetic COCO-caption pretraining batches (numpy), the geometry of the
JAX package's ``bench.py::synth_batch``: 128 text tokens + 100 regions of
2048-d features, 24 MLM slots per example. Copied so that a machine without
JAX can build them."""

from __future__ import annotations

import numpy as np


def synth_batch(batch, tt=128, tv=100, dv=2048, vocab=30522, seed=0, n_pred=24):
    rng = np.random.RandomState(seed)
    lm = np.full((batch, tt), -1, np.int32)
    positions = np.zeros((batch, n_pred), np.int32)
    for i in range(batch):
        pos = rng.choice(np.arange(1, tt), size=n_pred, replace=False)
        positions[i] = np.sort(pos)
        lm[i, pos] = rng.randint(0, vocab, size=n_pred)
    return {
        "mlm_positions": positions,
        "input_ids": rng.randint(0, vocab, size=(batch, tt)).astype(np.int32),
        "token_type_ids": np.zeros((batch, tt), np.int32),
        "input_mask": np.ones((batch, tt), np.int32),
        "visual_embeddings": rng.randn(batch, tv, dv).astype(np.float32),
        "image_mask": np.ones((batch, tv), np.int32),
        "masked_lm_labels": lm,
        "is_random_next": rng.randint(0, 2, size=(batch,)).astype(np.int32),
    }
