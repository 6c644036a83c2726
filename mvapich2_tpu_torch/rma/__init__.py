"""One-sided communication on device windows (``device.py``)."""

from .device import DeviceWin, direct_put

__all__ = ["DeviceWin", "direct_put"]
