"""Deterministic synthetic image-classification datasets (NumPy copy of
``repro.data.synthetic``: same generator, same bits).

MNIST/CIFAR-10 are replaced by class-conditional Gaussian image datasets
with matched shapes and per-class structure ("mnist-like": 28x28x1,
10 classes; "cifar-like": 32x32x3, 10 classes). Each class c has a smooth
prototype image mu_c (random low-frequency pattern) and samples
x = clip(mu_c + sigma * eps).

What matters for the paper's phenomena is preserved exactly:
  * classification is non-trivial but learnable by softmax regression,
  * the single-class / two-class per-device splits create the extreme data
    heterogeneity (large kappa) that drives the bias-variance trade-off.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str = "mnist-like"
    n_classes: int = 10
    image_shape: tuple = (28, 28, 1)
    n_train_per_class: int = 1200
    n_test_per_class: int = 200
    noise_sigma: float = 0.45
    seed: int = 0

    @property
    def dim(self) -> int:
        return int(np.prod(self.image_shape))


def _low_freq_prototype(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """Smooth random prototype: low-frequency Fourier mixture, in [0,1]."""
    h, w = shape[0], shape[1]
    c = shape[2] if len(shape) > 2 else 1
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.zeros((h, w, c))
    for ch in range(c):
        acc = np.zeros((h, w))
        for _ in range(6):
            fy, fx = rng.integers(1, 4, size=2)
            phase = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.4, 1.0)
            acc += amp * np.sin(2 * np.pi * fy * yy + phase[0]) \
                       * np.cos(2 * np.pi * fx * xx + phase[1])
        acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
        img[..., ch] = acc
    return img


def make_classification_dataset(spec: SyntheticSpec):
    """Returns (x_train, y_train, x_test, y_test), images flattened to (n,d)."""
    rng = np.random.default_rng(spec.seed)
    protos = [_low_freq_prototype(rng, spec.image_shape)
              for _ in range(spec.n_classes)]
    def sample(n_per_class, rng):
        xs, ys = [], []
        for cls in range(spec.n_classes):
            eps = rng.normal(size=(n_per_class,) + tuple(spec.image_shape))
            x = np.clip(protos[cls][None] + spec.noise_sigma * eps, 0.0, 1.0)
            xs.append(x.reshape(n_per_class, -1))
            ys.append(np.full(n_per_class, cls, dtype=np.int64))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys)
        perm = rng.permutation(x.shape[0])
        return x[perm], y[perm]

    x_tr, y_tr = sample(spec.n_train_per_class, rng)
    x_te, y_te = sample(spec.n_test_per_class, rng)
    # standardize features (helps conditioning; deterministic)
    mean, std = x_tr.mean(0, keepdims=True), x_tr.std(0, keepdims=True) + 1e-6
    x_tr = (x_tr - mean) / std
    x_te = (x_te - mean) / std
    return x_tr, y_tr, x_te, y_te

