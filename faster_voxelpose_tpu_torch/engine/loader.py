"""Batching and device prefetch of the port (counterpart of
`faster_voxelpose_tpu/engine/loader.py`): the JAX loader's record order,
batching, padding and worker pool, so that one seed gives the same
batches in both packages, and a prefetch thread that makes and uploads
batches ahead of the step.

- `DataLoader`: collated numpy batches.  The order is a seeded
  permutation per epoch (`_host_order`), strided across processes; a
  final short batch is padded to the static batch size by repeating its
  last sample, with `_valid` marking the real rows; `num_workers > 0`
  makes samples in a pool of spawn processes that rebuild the dataset
  from a `DatasetFactory` (their augmentation draws are then
  decorrelated per worker, as in the JAX package, and not reproducible).
  Without workers, samples are made in the calling thread in order, so
  that their augmentation draws follow the dataset's one RandomState.
- `prefetch_to_device`: a background thread iterates the loader, copies
  each batch into pinned host memory and on to the card on a side
  stream; the consumer's stream waits on an event recorded after the
  copy.  An exception in the thread is raised in the consumer (the JAX
  package's version ends the epoch silently instead).
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import threading
from typing import Dict, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..datasets.base import collate
from ..device import DeviceLike, resolve_device

_WORKER_DATASET = None


class DatasetFactory:
    """Picklable dataset constructor for spawn workers: rebuilds the
    dataset from (name, cfg, is_train) inside each worker process."""

    def __init__(self, dataset_name: str, cfg, is_train: bool):
        self.dataset_name = dataset_name
        self.cfg = cfg
        self.is_train = is_train

    def __call__(self):
        from ..datasets import get_dataset

        return get_dataset(self.dataset_name)(self.cfg, is_train=self.is_train)


def _worker_init(dataset_factory):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset_factory()
    # every worker rebuilds the dataset with the configured seed: decorrelate
    # the augmentation draws per worker, as the JAX package's workers do
    rng = getattr(_WORKER_DATASET, "_rng", None)
    if rng is not None:
        base = rng.randint(0, 2**31 - 1)
        _WORKER_DATASET._rng = np.random.RandomState((base + os.getpid()) % (2**31 - 1))


def _worker_get(idx: int):
    return _WORKER_DATASET[idx]


class DataLoader:
    """Map-style loader: shuffling, a fixed batch size, drop_last for
    static shapes in training; in order with a padded final batch for
    evaluation.  `process_count` / `process_index`: every process builds
    the same seeded order and takes a disjoint strided slice of it,
    truncated to one length on every process (batch_size is per
    process)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 0, seed: int = 0, dataset_factory=None,
                 process_count: int = 1, process_index: int = 0):
        if not (0 <= process_index < process_count):
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.process_count = process_count
        self.process_index = process_index
        self._rng = np.random.RandomState(seed)
        self._pool = None
        if num_workers > 0:
            if dataset_factory is None:
                raise ValueError("num_workers > 0 requires dataset_factory")
            self._pool = mp.get_context("spawn").Pool(
                num_workers, initializer=_worker_init, initargs=(dataset_factory,))

    def _host_order(self) -> np.ndarray:
        """This process's record indices: the seeded permutation of the
        epoch, strided per process and truncated to
        len(dataset) // process_count records on every process."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        if self.process_count > 1:
            per_host = len(order) // self.process_count
            order = order[self.process_index::self.process_count][:per_host]
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_count > 1:
            n = n // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._host_order()
        bs = self.batch_size
        end = len(order) - (len(order) % bs) if self.drop_last else len(order)
        for start in range(0, end, bs):
            idxs = order[start:start + bs].tolist()
            if self._pool is not None:
                samples = self._pool.map(_worker_get, idxs)
            else:
                samples = [self.dataset[i] for i in idxs]
            if len(samples) < bs:  # eval-time padding to a static shape
                samples = samples + [samples[-1]] * (bs - len(samples))
            batch = collate(samples)
            batch["_valid"] = np.arange(bs) < len(idxs)
            yield batch

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None


class _Failure(NamedTuple):
    error: BaseException


_END = object()


def _upload(batch: Dict[str, np.ndarray], device: torch.device,
            stream: Optional["torch.cuda.Stream"]):
    """(batch of tensors on `device`, the event after their copy or None);
    keys starting with '_' stay on the host."""
    out = {k: v for k, v in batch.items() if k.startswith("_")}
    arrays = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items() if k not in out}
    if stream is None:
        out.update({k: t.to(device) for k, t in arrays.items()})
        return out, None
    with torch.cuda.stream(stream):
        out.update({k: t.pin_memory().to(device, non_blocking=True) for k, t in arrays.items()})
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]], size: int = 2,
                       device: DeviceLike = None) -> Iterator[Dict[str, object]]:
    """Yield the batches of `iterator` as tensors on `device` (the CUDA
    device unless another is named), made and uploaded up to `size`
    batches ahead by a background thread.  On the card each batch is
    copied from pinned host memory on a side stream; before it is yielded
    the consumer's current stream waits for that copy, and its tensors
    are recorded as used there.  An exception raised by `iterator` is
    raised here, after the batches made before it.  Closing the generator
    stops the thread within one batch."""
    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            ctx = torch.cuda.device(device) if stream is not None else contextlib.nullcontext()
            with ctx:
                for batch in iterator:
                    if not put(_upload(batch, device, stream)):
                        return
            put(_END)
        except Exception as e:  # handed to the consumer, which raises it
            put(_Failure(e))

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.error
            batch, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for t in batch.values():
                    if isinstance(t, torch.Tensor):
                        t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        thread.join()
