"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repo
root (the hash covers the source and the flags, so an edited source
rebuilds). Nothing is built when a module is imported: the first launch
builds what it needs, and :func:`build` compiles several sources at once,
one nvcc process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("ota_combine", "dithered_quant", "payload", "row_reduce",
           "selective_scan", "linear_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (shutil.which("nvcc"),
                 CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                       "the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, in parallel.

    Returns ``{name: nvcc output}`` (the ``-Xptxas -v`` register and
    shared-memory report) for each source compiled by this call; raises
    with nvcc's output if any compile fails.
    """
    todo = [(name, *_target(name)) for name in names]
    todo = [t for t in todo if not t[2].exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for name, src, so in todo:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((name, proc, tmp, so))
        logs, failed = {}, []
        for name, proc, tmp, so in procs:
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode == 0:
                os.replace(tmp, so)
            else:
                failed.append(f"nvcc failed on {name}.cu:\n{out}")
    finally:
        for _, proc, tmp, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded ``lib<name>``, built on first use. ``signatures`` maps
    each exported function to its argtypes; every one returns the
    ``cudaError_t`` of its launch as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
