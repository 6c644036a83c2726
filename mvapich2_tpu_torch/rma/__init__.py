"""One-sided communication: host windows over the packet protocol
(``win.py``: the window flavors, the communication ops, fence, PSCW and
passive-target locks) and device windows (``device.py``)."""

from .device import DeviceWin, direct_put
from .win import (LOCK_EXCLUSIVE, LOCK_SHARED, Win, win_allocate,
                  win_allocate_shared, win_create, win_create_dynamic)

__all__ = ["DeviceWin", "direct_put", "Win", "win_create", "win_allocate",
           "win_allocate_shared", "win_create_dynamic", "LOCK_EXCLUSIVE",
           "LOCK_SHARED"]
