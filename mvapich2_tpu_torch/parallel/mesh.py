"""Device meshes of the port (counterpart of the JAX package's
``parallel/mesh.py`` ``make_mesh``).

A mesh here is a 1-D line of ``p`` ranks bound one to one to ``p``
virtual devices that all live on one ``torch.device``: ``p`` virtual
ranks inside one card's memory (the GPU analog of the JAX tests'
8-device virtual CPU mesh), or on the CPU for the tests. Each rank's
shard is its own allocation; one kernel launch covers all ``p`` ranks
(``ops/ring.py``, ``ops/ici.py``). Multi-axis meshes are not ported.

``MeshComm`` is a trimmed counterpart of the JAX package's: the mesh,
its axis, its size and its device, which ``rma/device.py``'s
``DeviceWin`` takes, and ``run``, the counterpart of its ``shard_map``
launch. Code run under it sees every rank's shard at once, stacked on
dim 0 (``ops/collectives.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``p`` ranks on one named axis over one device."""

    def __init__(self, size: int, axis_name: str, device: torch.device):
        self.size = int(size)
        self.axis_names: Tuple[str, ...] = (str(axis_name),)
        self.device = torch.device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}

    @property
    def devices(self) -> List[torch.device]:
        """The device each rank's shard lives on, in rank order."""
        return [self.device] * self.size

    def __repr__(self):
        return (f"Mesh({self.axis_names[0]}={self.size}, "
                f"device={self.device})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device) -> Mesh:
    """A 1-D mesh of ``shape[0]`` virtual ranks on ``device`` (a
    ``torch.device`` or its name, e.g. ``"cuda:0"`` or ``"cpu"``)."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != 1 or len(axis_names) != 1:
        raise NotImplementedError(
            f"mesh shape {shape} over axes {axis_names}: only 1-D meshes "
            f"are ported")
    if shape[0] < 1:
        raise ValueError(f"mesh size must be >= 1, got {shape[0]}")
    from ..runtime.universe import resolve_device
    return Mesh(shape[0], axis_names[0], resolve_device(device))


class MeshComm:
    """A communicator over the mesh's one axis."""

    def __init__(self, mesh: Mesh, axis=None):
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
