"""Build and bind the port's CUDA kernels.

The sources in ``eryn_tpu_torch/csrc/`` are compiled at first use by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface, and
loaded with :mod:`ctypes`.  The library lands in ``build/kernels/`` beside the
package, named by a hash of the sources and flags, so an edited source builds
anew and an unchanged one is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "function", "check", "library_path", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math: the NaN guards of the kernels depend on isnan.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
_functions = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc was not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels of eryn_tpu_torch need the CUDA "
            "toolkit to build."
        )
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path():
    """Path of the shared library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liberyn_kernels_{digest.hexdigest()[:16]}.so"


def _compile(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp)]
    cmd += [str(s) for s in _sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    # ptxas -v reports registers, shared memory and spills per kernel
    path.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, path)


def load():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            _lib = ctypes.CDLL(str(path))
    return _lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}


def function(name, signature):
    """The C function ``name`` of the kernel library, with its argument types
    declared from ``signature`` (one letter per argument: ``p`` pointer or
    stream, ``i`` int, ``d`` double).  It returns the CUDA error code of its
    launch."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err, name):
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")
