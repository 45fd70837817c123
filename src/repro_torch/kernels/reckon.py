"""Kernel calls on tensors that hold no data: the meta device and fake
tensors, on which ``launch/analysis.py`` reckons a step's cost and memory.

Such a call runs its wrapper's dtype, shape, device and layout checks and
returns ``torch.empty`` outputs of the plain version's shapes and dtypes;
nothing is launched, and the call counts on the wrapper's ``reckoned``
counter, never on ``launches``. A CUDA tensor still launches the kernel
or raises, and a CPU tensor still takes the plain version.

Observers (``observing``) see each such call's operands and results: the
cost counter charges it their bytes, as the reference's ``hlo_cost``
charges a custom call.
"""
from __future__ import annotations

import contextlib

import torch

_OBSERVERS: list = []


def abstract(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data: on the meta device, or a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    return t.device.type == "meta" or isinstance(t, FakeTensor)


def call(wrapper, inputs, outputs):
    """Count one reckoned call of ``wrapper`` and show it to the
    observers; returns ``outputs``."""
    wrapper.reckoned += 1
    for observe in _OBSERVERS:
        observe(wrapper.__name__, inputs, outputs)
    return outputs


@contextlib.contextmanager
def observing(observe):
    """Within the block, ``observe(name, inputs, outputs)`` is called on
    every reckoned kernel call (inputs and outputs: tensors, or tuples of
    them)."""
    _OBSERVERS.append(observe)
    try:
        yield
    finally:
        _OBSERVERS.remove(observe)
