"""PyTorch/CUDA port of ``repro`` (biased FL under wireless heterogeneity).

Mirrors the JAX package's layout (``core/``, ``data/``, ``fl/``,
``kernels/``, ``api/``) and imports neither JAX nor ``repro``: the hot ops of the
main path run as hand-written CUDA kernels for Hopper
(``kernels/csrc/``), everything else as plain PyTorch. Entry points take
an explicit ``device`` and default to the card.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
