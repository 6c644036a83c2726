"""Device meshes of the port (counterpart of the JAX package's
``parallel/mesh.py`` ``make_mesh``, ``mesh_shape_for`` and ``MeshComm``).

A mesh here is ``size`` virtual devices laid out on one or more named
axes (an ordered ``shape``), all living on one ``torch.device``: virtual
ranks inside one card's memory (the GPU analog of the JAX tests'
8-device virtual CPU mesh), or on the CPU for the tests. Ranks sit
row-major over the axes, as the JAX package flattens its device array:
on a ``(2, 4)`` mesh ``("x", "y")`` rank ``i*4 + j`` has coordinates
``(i, j)``. Each rank's shard is its own allocation; one kernel launch
covers all the ranks of a collective phase (``ops/ring.py``,
``ops/ici.py``).

``MeshComm`` is a trimmed counterpart of the JAX package's: the mesh,
its axis, its size and its device, which ``rma/device.py``'s
``DeviceWin`` takes, and ``run``, the counterpart of its ``shard_map``
launch. Code run under it sees every rank's shard at once, stacked on
dim 0 (``ops/collectives.py``). It spans one axis of a 1-D mesh; a
mesh of two or more axes raises ``NotImplementedError`` (the
multi-axis ``MeshComm.run`` comes with the models slice of ROADMAP
queue 1).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Ranks on named axes over one device: ``shape`` maps each axis
    name to its extent, in order; ``size`` is their product."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        shape = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(str(a) for a in axis_names)
        if len(shape) != len(self.axis_names) or not shape:
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if min(shape) < 1:
            raise ValueError(f"mesh extents must be >= 1, got {shape}")
        self._extents = shape
        self.size = math.prod(shape)
        self.device = torch.device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._extents))

    @property
    def devices(self) -> List[torch.device]:
        """The device each rank's shard lives on, in rank order."""
        return [self.device] * self.size

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes}, device={self.device})"


def mesh_shape_for(n: int, naxes: int = 2) -> Tuple[int, ...]:
    """Near-square factorization of ``n`` devices into ``naxes`` axes
    (own copy of the JAX package's)."""
    if naxes == 1:
        return (n,)
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    if naxes == 2:
        return best
    return (best[0],) + mesh_shape_for(best[1], naxes - 1)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("x",), device=None) -> Mesh:
    """A mesh of virtual ranks on ``device`` (a ``torch.device`` or its
    name, e.g. ``"cuda:0"`` or ``"cpu"``; ``None`` is ``cuda:0``).
    ``shape=None`` factors 8 ranks (the JAX tests' device count)
    near-square over the axes, as the JAX ``make_mesh`` factors its
    devices."""
    axis_names = tuple(axis_names)
    if shape is None:
        shape = mesh_shape_for(8, len(axis_names))
    from ..runtime.universe import resolve_device
    return Mesh(shape, axis_names, resolve_device(device))


class MeshComm:
    """A communicator over the one axis of a 1-D mesh."""

    def __init__(self, mesh: Mesh, axis=None):
        if len(mesh.axis_names) > 1:
            raise NotImplementedError(
                f"MeshComm over the {len(mesh.axis_names)}-axis mesh "
                f"{mesh}: a multi-axis MeshComm is not ported (ROADMAP "
                f"queue 1, the models slice); the collectives of "
                f"run_ranks(device_mesh=...) take multi-axis meshes")
        if axis is None:
            axis = mesh.axis_names[0]
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in {mesh.axis_names}")
        self.mesh = mesh
        self.axis = str(axis)

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def stack(self, x) -> torch.Tensor:
        """A global tensor (or array) split on dim 0 into the stacked
        layout ``[p, T/p, ...]`` on the mesh's device: row i is rank
        i's shard, as ``P(axis)`` shards it in the JAX package."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = torch.as_tensor(x, device=self.device)
        p = self.size
        if x.dim() < 1 or x.shape[0] % p:
            raise ValueError(f"MeshComm.run: dim 0 of shape "
                             f"{tuple(x.shape)} does not split over "
                             f"{p} ranks")
        return x.reshape((p, x.shape[0] // p) + tuple(x.shape[1:]))

    def run(self, fn: Callable, *args):
        """Counterpart of the JAX ``MeshComm.run`` with its default specs
        (``P(axis)`` in and out): split dim 0 of each global argument
        over the ranks (:meth:`stack`), call ``fn`` once on the stacked
        tensors, and concatenate every stacked result's ranks back on
        dim 0. ``fn`` sees all ranks at once; it takes this comm where
        the JAX function takes the axis name (close over it)."""
        out = fn(*(self.stack(a) for a in args))

        def unstack(y):
            if y.dim() < 2 or y.shape[0] != self.size:
                raise ValueError(f"MeshComm.run: result of shape "
                                 f"{tuple(y.shape)} is not stacked over "
                                 f"{self.size} ranks")
            return y.reshape((-1,) + tuple(y.shape[2:]))
        if isinstance(out, (tuple, list)):
            return type(out)(unstack(y) for y in out)
        return unstack(out)
