"""Batched, prefetching host loader and the batch's move to the device.

The port's copy of the JAX package's `data/loader.py` (which replaces the
reference's `torch.utils.data.DataLoader(num_workers, pin_memory)`,
train.py:244-274): a thread pool loads the items (PIL decode releases the
GIL), a producer thread stacks them into batches ahead of the consumer
through a bounded queue, and the shuffle is `np.random.default_rng(seed)`'s
permutation, one per epoch from the same generator. With `pin_memory` the
producer stacks each batch straight into page-locked tensors from PyTorch's
caching host allocator, so `to_device_batch` copies them with
`non_blocking=True`; that allocator does not hand a freed block out again
before the copies recorded on it have completed, so a pinned buffer is not
reused while a copy from it is in flight.

Over more than one rank (`parallel/dist.py`) every rank draws the same
shuffle and loads only its contiguous rows of each global batch, as the JAX
package's multi-host path feeds each host its rows (JAX
`parallel/mesh.py:25-43`). A batch that does not split over the ranks (a
validation set's last, or a batch size the world does not divide) is first
padded to the next multiple of the world size by repeating its last item,
with the padded rows' labels set to ignore (250), as the JAX trainer pads
validation batches for its mesh (JAX `engine/trainer.py:73-90, 417-423`);
such a batch carries `n_real`, the count of its real rows in the global
batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import dist

HOST_ONLY_KEYS = ("filename", "n_real")
PREFETCH = 2  # batches the producer stacks ahead of the consumer


def collate(items: List[Dict[str, Any]], pin_memory: bool = False) -> Dict[str, Any]:
    """Stack per-item dicts into a batch dict (numpy arrays, or pinned CPU
    tensors with `pin_memory`); host-only keys become lists."""
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if k in HOST_ONLY_KEYS:
            out[k] = vals
        elif pin_memory:
            first = np.asarray(vals[0])
            t = torch.empty((len(vals), *first.shape),
                            dtype=torch.from_numpy(first).dtype, pin_memory=True)
            np.stack(vals, out=t.numpy())
            out[k] = t
        else:
            out[k] = np.stack(vals)
    return out


def to_device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or pinned tensors, NHWC) -> NCHW tensors on
    `device`: host-only keys dropped (the JAX trainer's `device_batch`),
    labels as int64, images (4-dim: (N, H, W, C); intrinsics are (N, 4, 4))
    transposed on the device after the copy."""
    out = {}
    for k, v in batch.items():
        if k in HOST_ONLY_KEYS:
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        t = t.to(device, non_blocking=True)
        if k == "lbl":
            t = t.long()
        elif t.dim() == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t
    return out


class _Failure:
    """An exception of the producer thread, re-raised by the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class DataLoader:
    """Iterates shuffled batches; optional drop_last; worker thread pool."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0,
                 pin_memory: bool = False, shard: Optional[Tuple[int, int]] = None):
        """`shard` is (rank, world); by default the process group's."""
        self.rank, self.world = shard if shard is not None else (dist.rank(), dist.world())
        if drop_last and batch_size % self.world:
            raise ValueError(f"a train batch of {batch_size} does not split over "
                             f"{self.world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pin_memory = pin_memory
        self._rng = np.random.default_rng(seed)
        self._pool: Optional[ThreadPoolExecutor] = None
        # the epochs' producer threads and their cancel events, for close()
        self._producers: List[Tuple[threading.Thread, threading.Event]] = []

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = self._rng.permutation(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size: (b + 1) * self.batch_size]

    def rows(self, indices) -> Tuple[np.ndarray, Optional[int]]:
        """This rank's rows of the global batch `indices` (padded first where
        it does not split over the ranks) and the count of the global batch's
        real rows where it was padded (else None)."""
        n = len(indices)
        m = -(-n // self.world) * self.world
        n_real = None
        if m > n:
            indices = np.concatenate([indices, np.repeat(indices[-1:], m - n)])
            n_real = n
        k = m // self.world
        return indices[self.rank * k:(self.rank + 1) * k], n_real

    def _load_batch(self, indices) -> Dict[str, Any]:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        rows, n_real = self.rows(indices)
        batch = collate(list(self._pool.map(self.dataset.__getitem__, rows)), self.pin_memory)
        if n_real is not None:
            real = min(max(n_real - self.rank * len(rows), 0), len(rows))
            if "lbl" in batch:
                batch["lbl"][real:] = 250
            batch["n_real"] = n_real
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = object()
        cancelled = threading.Event()

        def put(x):
            while not cancelled.is_set():
                try:
                    q.put(x, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                for indices in self._batch_indices():
                    if cancelled.is_set():
                        return
                    put(self._load_batch(indices))
            except Exception as e:  # handed to the consumer, which re-raises it
                put(_Failure(e))
            finally:
                put(stop)

        t = threading.Thread(target=producer, daemon=True)
        self._producers = [(p, e) for p, e in self._producers if p.is_alive()]
        self._producers.append((t, cancelled))
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is stop:
                    break
                if isinstance(batch, _Failure):
                    raise batch.error
                yield batch
        finally:
            # an epoch left early: the producer stops after its current batch
            cancelled.set()

    def close(self) -> None:
        """Stop the producers of the epochs in flight, join them and shut the
        worker threads down (a later epoch starts new ones). A producer left
        running at exit could be stopped inside a pinned allocation."""
        for _, cancelled in self._producers:
            cancelled.set()
        for t, _ in self._producers:
            t.join()
        self._producers = []
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def infinite_iterator(loader: DataLoader) -> Iterator[Dict[str, Any]]:
    """reference train.py:111-114."""
    while True:
        for batch in loader:
            yield batch
