"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface
(``build/kernels/lib<name>-<hash>.so`` at the root of the checkout,
which ``.gitignore`` lists), loaded with ``ctypes``.  The hash covers
the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing builds at import: the first wrapper call on a
CUDA tensor builds its kernel (or :func:`build` builds several at once,
one ``nvcc`` process each, all started together).

A name ``"<source>:<MACRO>[,<MACRO>...]"`` builds ``csrc/<source>.cu``
once more with those macros defined (``-D``), as a library of its own
(a timing build; the wrappers load the plain name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas -v: each kernel's registers, shared memory and spill bytes,
# kept in LOGS for the caller to report
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}  # nvcc's output per kernel built in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def _source(name: str):
    """(source file, nvcc flags) of kernel library ``name``."""
    src, _, macros = name.partition(":")
    return CSRC / f"{src}.cu", NVCC_FLAGS + [
        f"-D{m}" for m in macros.split(",") if m]


def library_path(name: str) -> Path:
    src, flags = _source(name)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    stem = name.replace(":", "-").replace(",", "-")
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every kernel of ``names`` that has no library yet, one
    ``nvcc`` each, started together.  Returns seconds per name (0.0
    for a library that already existed).  Raises with nvcc's output
    when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        # write to a private name, rename into place once complete: a
        # concurrent builder never loads a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src, flags = _source(name)
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n"
                            f"{log.decode(errors='replace')}")
            continue
        LOGS[name] = log.decode(errors="replace")
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n"
                           + "\n".join(failures))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
