"""3-D 7-point stencil with halo exchange (counterpart of
``mvapich2_tpu/models/stencil.py``; BASELINE config 4, the 512^3 grid).

The grid is split on z over the ranks of a comm; each iteration
exchanges one-plane halos with both neighbours
(``ops/collectives.py`` ``halo_exchange``) and applies the 7-point
Jacobi update. Functions on shards take the stacked layout
(``[S, Zl, Y, X]``, dim 0 the mesh rank); run them through
``MeshComm.run``. Stock torch, as the JAX package leaves the exchange
(``lax.ppermute``) and the update to XLA."""

from __future__ import annotations

import torch

from ..ops.collectives import halo_exchange
from ..parallel.mesh import MeshComm, P
from ..runtime.universe import resolve_device


def _update(z0, z1, center):
    """The 7-point Jacobi update of ``center`` ``[..., Z, Y, X]`` from its
    z neighbours (y and x wrap around)."""
    y0 = torch.roll(center, 1, dims=-2)
    y1 = torch.roll(center, -1, dims=-2)
    x0 = torch.roll(center, 1, dims=-1)
    x1 = torch.roll(center, -1, dims=-1)
    return (z0 + z1 + y0 + y1 + x0 + x1 - 6.0 * center) / 6.0 + center


def stencil_step(u: torch.Tensor, comm: MeshComm,
                 periodic: bool = True) -> torch.Tensor:
    """One Jacobi update of every rank's ``[Zl, Y, X]`` block, stacked
    ``[S, Zl, Y, X]`` (halo width 1 along the split z dim)."""
    up = halo_exchange(u, comm, halo=1, dim=0, periodic=periodic)
    return _update(up[:, :-2], up[:, 2:], up[:, 1:-1])


def initial_grid(grid: int, device=None) -> torch.Tensor:
    """The JAX ``run_stencil``'s start, ``(arange(grid^3, f32) % 97) /
    97`` as a ``[grid]^3`` f32 cube on ``device`` (``None`` is
    ``cuda:0``): the index rounded to f32 as the f32 ``arange`` rounds it
    (past 2^24 elements, the 512^3 grid, it is not exact), its remainder
    taken exactly in f32."""
    u = torch.arange(grid ** 3, dtype=torch.int64,
                     device=resolve_device(device))
    u = torch.fmod(u.to(torch.float32), 97.0) / 97.0
    return u.reshape(grid, grid, grid)


def run_stencil(comm: MeshComm, grid: int = 64, iters: int = 4,
                periodic: bool = True, u: torch.Tensor = None
                ) -> torch.Tensor:
    """Run ``iters`` stencil steps on a ``[grid]^3`` cube split on z over
    the comm's ranks; ``u`` (default :func:`initial_grid`) is the start.
    Returns the global cube."""
    p = comm.size
    if grid % p:
        raise ValueError(f"grid {grid} does not split over {p} ranks")
    if u is None:
        u = initial_grid(grid, comm.device)

    def body(ushard):
        for _ in range(iters):
            ushard = stencil_step(ushard, comm, periodic)
        return ushard

    return comm.run(body, u, in_specs=(P(comm.axis),),
                    out_specs=P(comm.axis))


def reference_stencil(u: torch.Tensor, iters: int,
                      periodic: bool = True) -> torch.Tensor:
    """Single-device reference for correctness checks."""
    for _ in range(iters):
        if periodic:
            z0 = torch.roll(u, 1, dims=0)
            z1 = torch.roll(u, -1, dims=0)
        else:
            zpad = torch.nn.functional.pad(u, (0, 0, 0, 0, 1, 1))
            z0, z1 = zpad[:-2], zpad[2:]
        u = _update(z0, z1, u)
    return u
