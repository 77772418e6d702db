"""Host-side input pipeline: seeded per-example transforms, fixed-shape
batching, background prefetch. A copy of the thread-mode part of
``visualbert_tpu/data/pipeline.py`` (importing the JAX package pulls in
JAX); its batches are byte-identical to the JAX package's.

  * **Static shapes**: every example is padded to the task's fixed
    (text_len, n_regions) bucket on the host.
  * **Reproducible randomness**: transforms receive a Generator keyed by
    (seed, epoch, index), so a batch does not depend on the worker count.
  * **Prefetch**: one background thread keeps a bounded queue of ready
    batches while the device runs.

The JAX Batcher's process mode (forked workers filling shared memory) and
its multi-host ``process_shard`` are not ported (ROADMAP.md A6, A9).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


class Batcher:
    """Iterate batches of a dataset with per-epoch shuffling.

    A dataset is indexed with ``(index, rng)``, rng a ``np.random.Generator``
    derived from ``(seed, epoch, index)``. ``num_workers > 0`` fetches the
    samples of each batch through a thread pool, bit-identical to the
    sequential path. ``pad_final`` repeats indices to fill the last batch
    and marks every batch with ``example_weight`` (0 on the repeats) and the
    host-side ``_real_count``. A dataset's ``batch_transform(batch, rng)``,
    when it has one, runs on each finished batch with a Generator keyed by
    (seed, epoch, start, 1), as in the JAX package (the in-batch random
    feature replacement of ``data/masking.py``)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        pad_final: bool = False,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.num_workers = num_workers
        self._pool: Optional[ThreadPoolExecutor] = None

    def _get_pool(self) -> Optional[ThreadPoolExecutor]:
        if self._pool is None and self.num_workers > 0:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def close(self):
        """Stop the worker threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _fetch(self, epoch: int, i: int):
        rng = np.random.default_rng((self.seed, epoch, int(i)))
        return self.dataset[(int(i), rng)]

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        pool = self._get_pool()
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            n_real = len(idx)
            if len(idx) < self.batch_size:
                if self.drop_last:
                    break
                if self.pad_final:
                    # repeat the last indices so shapes stay static
                    idx = np.resize(idx, self.batch_size)

            # fill-into-buffer collate: each sample is written straight into
            # the batch arrays (the workers parallelise the visual-feature
            # copy), the arrays default_collate would stack, without its
            # second pass over the batch
            first = self._fetch(epoch, int(idx[0]))
            batch = {k: np.empty((len(idx),) + np.shape(v), np.asarray(v).dtype) for k, v in first.items()}
            for k, v in first.items():
                batch[k][0] = v
            keyset = set(first)

            def fill(j):
                s = self._fetch(epoch, int(idx[j]))
                if set(s) != keyset:
                    # np.empty rows must never be yielded uninitialised
                    raise KeyError(f"sample {int(idx[j])} keys {sorted(s)} != batch keys {sorted(keyset)}")
                for k, v in s.items():
                    batch[k][j] = v

            if pool is not None:
                list(pool.map(fill, range(1, len(idx))))
            else:
                for j in range(1, len(idx)):
                    fill(j)
            if self.pad_final:
                weights = np.zeros(len(idx), np.float32)
                weights[:n_real] = 1.0
                batch["example_weight"] = weights
                batch["_real_count"] = float(n_real)  # '_' keys never reach the device
            transform = getattr(self.dataset, "batch_transform", None)
            if transform is not None:
                # the trailing 1 keeps the key apart from the samples' (seed, epoch, index)
                batch = transform(batch, np.random.default_rng((self.seed, epoch, start, 1)))
            yield batch

    def num_batches(self) -> int:
        """Batches an epoch yields."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread, keep `size` items ready."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    END = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surfaced in the consumer
            err.append(e)
        finally:
            q.put(END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is END:
            if err:
                raise err[0]
            return
        yield item


def pad_to(arr: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """Zero-pad (or truncate) `arr` to `length` along `axis`."""
    cur = arr.shape[axis]
    if cur == length:
        return arr
    if cur > length:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, length)
        return arr[tuple(sl)]
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, length - cur)
    return np.pad(arr, pad_width)


def pad_regions(feats: np.ndarray, max_regions: int):
    """Pad region features [n, D] -> ([max, D], mask [max]). 16-bit feature
    caches stay 16-bit, anything else becomes fp32."""
    n = min(feats.shape[0], max_regions)
    arr = np.asarray(feats)
    if arr.dtype.itemsize != 2:
        arr = np.asarray(arr, np.float32)
    mask = np.zeros(max_regions, np.int32)
    mask[:n] = 1
    return pad_to(arr, max_regions, axis=0), mask
