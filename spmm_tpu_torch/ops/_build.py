"""Build and load the port's CUDA kernels (``spmm_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``.  Libraries go to ``build/spmm_tpu_torch/``
beside the package, named by a hash of the source, so a changed source is
rebuilt and an unchanged one is loaded as it is (``ops._host_build``, which
builds the host libraries the same way).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import torch

from spmm_tpu_torch.ops._host_build import (
    BUILD_DIR, CSRC, compile_library, hashed_path)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str, source: Optional[Path] = None) -> Path:
    return hashed_path(name, source or CSRC / f"{name}.cu", NVCC_FLAGS)


def build(name: str, source: Optional[Path] = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``source``, another version of it)
    unless its library exists; returns its path.  The compiler's report
    (registers, shared memory, spills) is kept beside the library as
    ``<lib>.log``."""
    source = source or CSRC / f"{name}.cu"
    out = library_path(name, source)
    return out if out.exists() else compile_library(name, source,
                                                    nvcc_path(), NVCC_FLAGS)


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock: a process may launch
    from more than one thread (a service's batching thread beside its
    caller's)."""
    with _count_lock:
        wrapper.launches += 1


def check_no_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would want a gradient through ``kernel``: grad mode
    is on and an input requires one.  The kernels have no backward, and a
    result written through ctypes carries no ``grad_fn``, so the gradient
    would otherwise be lost without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: run it under torch.no_grad(), or "
            f"train with attention_impl='plain'")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use.  The
    build runs outside the lock, so that several sources compile at once."""
    with _lock:
        lib = _loaded.get(name)
    if lib is None:
        path = build(name)
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(path)))
    return lib
