"""Buffers carried across from the JAX package.

What crosses is the ``(R, n)`` numpy rank buffers that the JAX tests
feed to ``hbm_slot_allreduce`` and ``pack_interleaved``, the MoE step
bench's one weight, its ``dmodel x dmodel`` expert matrix ``W``, the
``(p, n)`` rows of a one-sided device window (``np.asarray`` of the JAX
``DeviceWin.win``), the quant tier's int32 wire words, and the
transformer's parameters (the JAX ``init_params`` pytree as numpy, into
the port's stacked per-spec layout and back).
These functions put the same bytes into the port's tensors and back, so
both sides of a parity test see identical inputs: uint16, uint32 and
int32 (wire words included) cross unchanged, bfloat16 bit for bit.
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


def expert_from_numpy(w: np.ndarray, device="cpu") -> torch.Tensor:
    """The MoE bench's expert matrix ``W`` (``bench/moe.py``), given as
    numpy (e.g. ``np.asarray`` of the JAX bench's ``W``), as a float32
    ``(dmodel, dmodel)`` tensor on ``device``."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"expected a square expert matrix, got {w.shape}")
    return torch.from_numpy(w).to(device)


def window_from_numpy(rows: np.ndarray, device="cpu") -> torch.Tensor:
    """A device window's ``(p, n)`` rows, given as numpy, as the port's
    window state: a contiguous ``(p, n)`` tensor on ``device`` in the
    same dtype (numpy's ``bfloat16`` of ``ml_dtypes`` becomes
    ``torch.bfloat16``). Assign it to ``DeviceWin.win``."""
    rows = np.ascontiguousarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"expected (p, n) window rows, got {rows.shape}")
    if rows.dtype.name == "bfloat16":
        t = torch.from_numpy(rows.view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(rows.copy())
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of the same shape, on the
    host (``bfloat16`` as ``float32``, which holds every value)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(params, cfg, mesh):
    """The JAX transformer's ``init_params`` pytree, given as numpy
    arrays (``{name: np.asarray(leaf)}``), as the port's stacked
    parameters on ``mesh`` (``models/transformer.py`` ``shard_params``:
    each one split under its spec)."""
    from .models import transformer
    return transformer.shard_params(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in params.items()}, cfg, mesh)


def params_to_numpy(params, cfg, mesh):
    """The way back: the port's stacked parameters as global numpy
    arrays, one a name (a replicated parameter is rank 0's copy)."""
    from .models import transformer
    return {k: to_numpy(v)
            for k, v in transformer.unshard_params(params, cfg,
                                                   mesh).items()}
