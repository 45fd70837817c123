"""Non-i.i.d. data partitioners (Sec. V's heterogeneous splits)."""
from __future__ import annotations

import numpy as np


def partition_by_class(x: np.ndarray, y: np.ndarray, n_devices: int,
                       classes_per_device: int, samples_per_device: int,
                       seed: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
    """Assign each device `classes_per_device` classes and draw its samples
    only from those classes (paper: 1 for MNIST/N=10..50, 2 for CIFAR).

    Classes are assigned round-robin so every class is covered when
    n_devices >= n_classes (e.g. N=50, 10 classes -> 5 devices per class).
    """
    rng = np.random.default_rng(seed)
    n_classes = int(y.max()) + 1
    idx_by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    cursors = [0] * n_classes
    shards = []
    for m in range(n_devices):
        classes = [(m * classes_per_device + j) % n_classes
                   for j in range(classes_per_device)]
        per_cls = samples_per_device // classes_per_device
        xs, ys = [], []
        for c in classes:
            idx = idx_by_class[c]
            take = idx[cursors[c]:cursors[c] + per_cls]
            if take.shape[0] < per_cls:     # wrap around (re-use) if exhausted
                cursors[c] = 0
                take = idx[:per_cls]
            cursors[c] += per_cls
            xs.append(x[take])
            ys.append(y[take])
        shards.append((np.concatenate(xs), np.concatenate(ys)))
    return shards



def partition_iid(x: np.ndarray, y: np.ndarray, n_devices: int,
                  samples_per_device: int, seed: int = 0):
    """Homogeneous split (used in ablations)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(x.shape[0])
    shards = []
    for m in range(n_devices):
        take = perm[m * samples_per_device:(m + 1) * samples_per_device]
        shards.append((x[take], y[take]))
    return shards
