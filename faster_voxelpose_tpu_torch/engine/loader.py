"""Batching of the port (counterpart of `faster_voxelpose_tpu/engine/loader.py`):
`torch.utils.data.DataLoader` over a port dataset, with the JAX loader's
record order and its `collate`, so that one seed gives the same batches
in both packages.

The order is the JAX loader's `_host_order` on one host:
np.random.RandomState(seed) shuffles the record indices anew for every
epoch.  Batches are collated numpy dicts; `engine.trainer.batch_to_device`
moves one to the card.  Samples are made in the calling process, so that
their augmentation draws follow the dataset's one RandomState as the JAX
loader's do without a pool.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
from torch.utils.data import DataLoader, Sampler

from ..datasets.base import collate


class HostOrderSampler(Sampler):
    """Record indices in the JAX loader's order (engine/loader.py:104-120
    of the JAX package, one host): a seeded permutation per epoch when
    shuffling, else the records in order."""

    def __init__(self, n_records: int, shuffle: bool, seed: int = 0):
        self.n_records, self.shuffle = n_records, shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.n_records

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n_records)
        if self.shuffle:
            self._rng.shuffle(order)
        return iter(order.tolist())


def make_loader(dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                seed: int = 0) -> DataLoader:
    """A DataLoader of collated numpy batches in the JAX loader's order:
    the samples, augmentation draws included, equal the JAX loader's for
    the same seed.  Without drop_last the last batch is short: PyTorch
    needs no static shapes, so it is not padded as the JAX loader pads it."""
    sampler = HostOrderSampler(len(dataset), shuffle, seed)
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler, drop_last=drop_last,
                      collate_fn=collate)
