"""Chain storage backends of the port."""

from .backend import Backend
from .devicebackend import DeviceBackend

__all__ = ["Backend", "DeviceBackend"]
