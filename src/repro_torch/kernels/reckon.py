"""Kernel calls on tensors that hold no data: the meta device and fake
tensors, on which ``launch/analysis.py`` reckons a step's cost and memory.

Such a call runs its wrapper's dtype, shape, device and layout checks and
returns ``torch.empty`` outputs of the plain version's shapes and dtypes;
nothing is launched, and the call counts on the wrapper's ``reckoned``
counter, never on ``launches``. A CUDA tensor still launches the kernel
or raises, and a CPU tensor still takes the plain version.

Observers (``observing``) see each such call's operands and results: the
cost counter charges it their bytes, as the reference's ``hlo_cost``
charges a custom call. A collective of ``core/dist.py`` on such
a tensor moves nothing either; its observers (``observing_collectives``)
see the op, the tensor and the number of ranks.
"""
from __future__ import annotations

import contextlib

import torch

_OBSERVERS: list = []
_COLLECTIVE_OBSERVERS: list = []


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


def collective(op: str, t: torch.Tensor, ranks: int) -> torch.Tensor:
    """Show one reckoned collective ``op`` of ``t`` over ``ranks`` ranks to
    the collective observers; returns ``t`` (its result's shape)."""
    for observe in _COLLECTIVE_OBSERVERS:
        observe(op, t, ranks)
    return t


@contextlib.contextmanager
def observing_collectives(observe):
    """Within the block, ``observe(op, tensor, ranks)`` is called on every
    reckoned collective."""
    _COLLECTIVE_OBSERVERS.append(observe)
    try:
        yield
    finally:
        _COLLECTIVE_OBSERVERS.remove(observe)
