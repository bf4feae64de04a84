"""Chain storage backends of the port."""

from .backend import Backend
from .devicebackend import DeviceBackend
from .hdfbackend import HDFBackend, TempHDFBackend

__all__ = ["Backend", "DeviceBackend", "HDFBackend", "TempHDFBackend",
           "get_test_backends"]


def get_test_backends():
    """Backends usable for testing (as ``eryn_tpu.backends``): the
    in-memory backend, and the temporary-file HDF5 backend where ``h5py``
    is installed."""
    backends = [Backend]
    try:
        import h5py  # noqa: F401
    except ImportError:
        return backends
    return backends + [TempHDFBackend]
