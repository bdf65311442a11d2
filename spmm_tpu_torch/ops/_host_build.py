"""Build the port's host libraries (``spmm_tpu_torch/csrc/*.cpp``) with the
host C++ compiler, and the hashed build every library of the port goes
through (``ops._build`` compiles the CUDA sources with it).

A library goes to ``build/spmm_tpu_torch/`` beside the package, named by a
hash of its source and flags, so a changed source is rebuilt and an
unchanged one is used as it is.  Two builds of one source write separate
temporary files and rename them into place, so concurrent builds are safe.
The compiler's report is kept beside the library as ``<lib>.log``.  This
module imports no torch: the tokenizer builds through it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "spmm_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def hashed_path(name: str, source: Path, flags: list) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_library(name: str, source: Path, compiler: str,
                    flags: list) -> Path:
    """``compiler flags -o <lib> source`` unless the library exists;
    returns its path, or raises RuntimeError with the compiler's report."""
    out = hashed_path(name, source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / (f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp.so")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed for "
                           f"{source.name}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX or put c++ on PATH)")


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` with the host compiler
    (``c++ -O3 -std=c++17 -shared -fPIC``) unless its library exists."""
    source = CSRC / f"{name}.cpp"
    out = hashed_path(name, source, CXX_FLAGS)
    return out if out.exists() else compile_library(name, source,
                                                    cxx_path(), CXX_FLAGS)
