"""Hand-written CUDA kernels of the port's main path, their plain PyTorch
versions and their callers:

  ota_combine     — fused OTA post-scale + noise epilogue (eq. (6)), with
                    the noise given, or drawn in the kernel from a
                    threefry key (``ota_combine_keyed``)
  dithered_quant  — dithered quantize-dequantize (Sec. II-B), per row
                    and for one whole tensor
  payload         — the digital wire format at gradient scale: quantize and
                    bit-pack, unpack and dequantize, and the packed
                    weighted sum in device order
  row_reduce      — per-row (max |g|, sum g^2) in a wider accumulator, the
                    device scores of the norm-based digital baselines
  selective_scan  — the fused Mamba-1 selective scan of a model's prefill
  linear_scan     — the first-order linear scan h_t = a_t h_{t-1} + b_t,
                    the RG-LRU recurrence of a model's prefill

Each wrapper counts its launches in ``<wrapper>.launches``, and its calls
on tensors without data (the meta device, fake tensors), which launch
nothing, in ``<wrapper>.reckoned`` (``reckon.py``); the sources build
with nvcc at first use (``build.py``).
"""
from . import ops, ref
from .dithered_quant import dithered_quantize, dithered_quantize_rows
from .linear_scan import linear_scan
from .ota_combine import ota_combine, ota_combine_keyed
from .payload import (packed_weighted_sum, quantize_pack_rows,
                      unpack_dequant_rows)
from .row_reduce import row_maxabs_sumsq
from .selective_scan import selective_scan

KERNELS = (ota_combine, dithered_quantize_rows, quantize_pack_rows,
           unpack_dequant_rows, packed_weighted_sum, row_maxabs_sumsq,
           selective_scan, dithered_quantize, linear_scan,
           ota_combine_keyed)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def reckoned_counts() -> dict:
    """{kernel name: calls on tensors without data, which launch nothing}."""
    return {k.__name__: k.reckoned for k in KERNELS}
