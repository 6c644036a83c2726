"""Rank buffers carried across from the JAX package's tests.

The system runs no model, so nothing like weights crosses over: what
crosses is the ``(R, n)`` numpy rank buffers that the JAX tests feed to
``hbm_slot_allreduce`` and ``pack_interleaved``. These two functions put
the same bytes into the port's tensors and back, so both sides of a
parity test see identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hbm import L


def slots_from_numpy(bufs: np.ndarray, layout: str = "rows",
                     device="cpu") -> torch.Tensor:
    """``(R, n)`` numpy rank buffers -> a tensor on ``device``:

    * ``"rows"``: ``(R, n)`` as given (the input of hbm_slot_allreduce);
    * ``"planar"``: ``(R, n/128, 128)``;
    * ``"interleaved"``: ``(n/128, R, 128)`` (pack_interleaved's layout).
    """
    bufs = np.ascontiguousarray(bufs)
    if bufs.ndim != 2:
        raise ValueError(f"expected (R, n) rank buffers, got {bufs.shape}")
    t = torch.from_numpy(bufs)
    R, n = bufs.shape
    if layout == "rows":
        pass
    elif layout in ("planar", "interleaved"):
        if n % L:
            raise ValueError(f"{layout} slots need n % {L} == 0, got n={n}")
        t = t.reshape(R, n // L, L)
        if layout == "interleaved":
            t = t.permute(1, 0, 2).contiguous()
    else:
        raise ValueError(f"bad layout {layout!r}")
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of the same shape, on the
    host."""
    return t.detach().cpu().numpy()
