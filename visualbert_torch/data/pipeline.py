"""Host-side input pipeline: seeded per-example transforms, fixed-shape
batching, background prefetch. A copy of ``visualbert_tpu/data/pipeline.py``
(importing the JAX package pulls in JAX); its batches are byte-identical to
the JAX package's.

  * **Static shapes**: every example is padded to the task's fixed
    (text_len, n_regions) bucket on the host.
  * **Reproducible randomness**: transforms receive a Generator keyed by
    (seed, epoch, index), so a batch does not depend on the worker count.
  * **Workers**: threads, or forked processes that write their rows
    straight into a shared-memory batch (``worker_mode="process"``); both
    give the sequential path's batches bit for bit.
  * **Prefetch**: one background thread keeps a bounded queue of ready
    batches while the device runs.

The JAX Batcher's multi-host ``process_shard`` is not ported (ROADMAP.md
A9).
"""

from __future__ import annotations

import queue
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def _shm_open(name: str):
    """Attach an existing shared-memory segment without registering it with
    this process's resource tracker (the creator owns the unlink; tracked
    attachments in forked workers report leaks)."""
    from multiprocessing import shared_memory

    try:  # Python >= 3.13
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:
        # before 3.13: suppress the registration while attaching. Forked
        # workers share the parent's tracker, whose cache is keyed by name,
        # so unregistering here would erase the parent's own entry.
        from multiprocessing import resource_tracker

        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig


def _proc_worker_main(dataset, seed, task_q, done_q):
    """One fill worker: takes (epoch, idx, j0, j1, schema, slot name) tasks
    and writes rows j0..j1 of the batch straight into the shared-memory
    slot, so no sample is pickled back. Slots are reused across batches and
    stay mapped here."""
    import traceback

    attached = {}
    while True:
        task = task_q.get()
        if task is None:
            return
        epoch, idx, j0, j1, schema, slot_name = task
        try:
            shm = attached.get(slot_name)
            if shm is None:
                shm = attached[slot_name] = _shm_open(slot_name)
            bufs = {k: np.ndarray(shape, dtype=dtype, buffer=shm.buf, offset=off)
                    for k, (shape, dtype, off) in schema.items()}
            for j in range(j0, j1):
                i = int(idx[j])
                s = dataset[(i, np.random.default_rng((seed, epoch, i)))]
                if set(s) != set(schema):
                    raise KeyError(f"sample {i} keys {sorted(s)} != batch keys {sorted(schema)}")
                for k, v in s.items():
                    bufs[k][j] = v
            del bufs
            done_q.put((j0, j1, None))
        except BaseException:
            done_q.put((j0, j1, traceback.format_exc()))


def default_collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


class Batcher:
    """Iterate batches of a dataset with per-epoch shuffling.

    A dataset is indexed with ``(index, rng)``, rng a ``np.random.Generator``
    derived from ``(seed, epoch, index)``. ``num_workers > 0`` fetches the
    samples of each batch through a thread pool (``worker_mode="thread"``)
    or forked worker processes that fill a shared-memory batch
    (``"process"``: for per-sample Python work that would hold the GIL),
    both bit-identical to the sequential path. ``pad_final`` repeats indices to fill the last batch
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
        worker_mode: str = "thread",
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}: 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self._pool: Optional[ThreadPoolExecutor] = None
        self._procs = None
        self._free_slots: Dict[int, list] = {}
        self._all_slots: list = []
        self._closed = False

    def _get_pool(self) -> Optional[ThreadPoolExecutor]:
        if self._pool is None and self.num_workers > 0 and self.worker_mode == "thread":
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def _get_procs(self):
        """Fork the worker processes on first use: fork, so the dataset (its
        feature caches included) is inherited copy-on-write, unpickled."""
        if self._procs is None:
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            self._task_q, self._done_q = ctx.Queue(), ctx.Queue()
            self._procs = [ctx.Process(target=_proc_worker_main, args=(self.dataset, self.seed, self._task_q,
                                                                        self._done_q), daemon=True)
                           for _ in range(self.num_workers)]
            for p in self._procs:
                p.start()
        return self._procs

    def close(self):
        """Stop the worker threads or processes and unlink the shared
        memory. Terminal: an epoch still running afterwards raises."""
        self._closed = True
        if self._procs is not None:
            for _ in self._procs:
                self._task_q.put(None)
            for p in self._procs:
                p.join(timeout=5)
            self._procs = None
        for shm in self._all_slots:
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        self._all_slots, self._free_slots = [], {}
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _acquire_slot(self, nbytes: int):
        """A shared-memory slot of ``nbytes``, reused when free: a fresh
        segment pays the kernel's page zeroing on first touch. A slot is
        free again once every array over it has been collected, so a batch
        still held is never overwritten."""
        from multiprocessing import shared_memory

        if self._closed:
            raise RuntimeError("Batcher is closed")
        free = self._free_slots.setdefault(nbytes, [])
        if free:
            return free.pop()
        shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self._all_slots.append(shm)
        return shm

    def _fill_shared(self, epoch: int, idx, first: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Process-mode batch assembly: every key laid out in one shared
        slot (64-byte aligned), contiguous row spans handed to the workers,
        the slot's arrays returned."""
        self._get_procs()
        B = len(idx)
        schema, off = {}, 0
        for k, v in first.items():
            a = np.asarray(v)
            schema[k] = ((B,) + a.shape, a.dtype, off)
            off += -(-(B * a.nbytes) // 64) * 64
        nbytes = max(64, off)
        shm = self._acquire_slot(nbytes)
        bufs = {k: np.ndarray(shape, dtype=dtype, buffer=shm.buf, offset=o) for k, (shape, dtype, o) in schema.items()}
        pending = {"n": len(bufs)}
        free = self._free_slots[nbytes]

        def release(pending=pending, free=free, shm=shm):
            pending["n"] -= 1
            if pending["n"] == 0:
                free.append(shm)

        for arr in bufs.values():
            weakref.finalize(arr, release)
        for k, v in first.items():
            bufs[k][0] = v
        n_tasks = 0
        for span in np.array_split(np.arange(1, B), len(self._procs)):
            if len(span):
                self._task_q.put((epoch, np.asarray(idx), int(span[0]), int(span[-1]) + 1, schema, shm.name))
                n_tasks += 1
        errors = []
        for _ in range(n_tasks):
            while True:
                try:
                    _, _, err = self._done_q.get(timeout=60)
                    break
                except queue.Empty:
                    dead = [p for p in self._procs if not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"{len(dead)} batch worker(s) died (exit codes "
                                           f"{[p.exitcode for p in dead]})")
            if err is not None:
                errors.append(err)
        if errors:
            raise RuntimeError("worker failure:\n" + "\n".join(errors))
        return bufs

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
            if self.worker_mode == "process" and self.num_workers > 0 and len(idx) > 1:
                batch = self._fill_shared(epoch, idx, first)
            else:
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
