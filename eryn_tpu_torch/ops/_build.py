"""Build and bind the port's CUDA kernels.

The sources in ``eryn_tpu_torch/csrc/`` are compiled at first use by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` per source in parallel, and linked into
one shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``build/kernels/`` beside the package, named by a hash of
the sources and flags, so an edited source builds anew and an unchanged one
is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "function", "launch", "check", "library_path", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math: the NaN guards of the kernels depend on isnan.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liberyn_kernels_{digest.hexdigest()[:16]}.so"


def _compile(path):
    """One ``nvcc -c`` per source, all started together, then one link."""
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), path.with_suffix(f".{os.getpid()}")
    tmp = Path(f"{tag}.tmp")
    objects = [Path(f"{tag}.{src.stem}.o") for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-I", str(_CSRC), "-o", str(obj),
             str(src)] for src, obj in zip(_sources(), objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    runs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in runs):
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        runs.append((cmd, proc.stdout, proc.returncode))
    for obj in objects:
        obj.unlink(missing_ok=True)
    # ptxas -v reports registers, shared memory and spills per kernel
    path.with_suffix(".log").write_text(
        "\n".join(" ".join(cmd) + "\n" + out for cmd, out, _ in runs)
    )
    for cmd, out, rc in runs:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with exit code {rc}:\n{out}")
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


def launch(symbol, name, device_index, signature, *args):
    """Call the C function ``symbol``, whose last argument is the stream, on
    the current stream of device ``device_index``, and raise if the launch
    failed.  The raw stream handle is the one PyTorch's own compiler reads
    (``torch._C._cuda_getCurrentRawStream``): building a ``torch.cuda.Stream``
    object per call costs host time on every launch."""
    import torch

    fn = function(symbol, signature)
    if device_index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    else:
        with torch.cuda.device(device_index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    check(err, name)


def check(err, name):
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")
