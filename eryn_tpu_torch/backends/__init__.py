"""Chain storage backends of the port."""

from .backend import Backend
from .devicebackend import DeviceBackend
from .hdfbackend import HDFBackend, TempHDFBackend

__all__ = ["Backend", "DeviceBackend", "HDFBackend", "TempHDFBackend"]
