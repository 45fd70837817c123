"""Per-device dataset handles and mini-batch sampling (NumPy copy of
``repro.data.loader``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DeviceDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return self.x.shape[0]

    def batch(self, batch_size: Optional[int],
              rng: Optional[np.random.Generator] = None, *,
              indices: Optional[np.ndarray] = None):
        """Full-batch when batch_size is None (paper Sec. V: |B|=|D|).

        Mini-batches take the counter-based draw
        (``core.rngstream.batch_indices``, the engine's) as ``indices``;
        a sequential ``rng`` is the legacy path and needs ``indices`` to
        be None.
        """
        if rng is not None and indices is not None:
            raise ValueError("pass counter-based indices OR a legacy rng, "
                             "not both (the rng would be silently unused)")
        if batch_size is None or batch_size >= len(self):
            return self.x, self.y
        if indices is None:
            if rng is None:
                raise ValueError(
                    "mini-batch draw needs counter-based indices "
                    "(core.rngstream.batch_indices) or a legacy rng")
            idx = rng.choice(len(self), size=batch_size, replace=False)
        else:
            idx = np.asarray(indices)
        return self.x[idx], self.y[idx]


@dataclasses.dataclass
class FLDataset:
    devices: list          # list[DeviceDataset]
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_devices(self):
        return len(self.devices)

    @classmethod
    def from_shards(cls, shards, x_test, y_test):
        return cls([DeviceDataset(x, y) for x, y in shards], x_test, y_test)
