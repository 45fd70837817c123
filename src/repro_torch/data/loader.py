"""Per-device dataset handles (NumPy copy of ``repro.data.loader``).

The port's slice trains full-batch (|B| = |D|, paper Sec. V), so a device
dataset is just its arrays; mini-batch draws arrive with ROADMAP Queue 1
item 9.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DeviceDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return self.x.shape[0]


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
