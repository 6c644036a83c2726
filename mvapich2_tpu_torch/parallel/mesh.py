"""Device meshes of the port (counterpart of the JAX package's
``parallel/mesh.py`` ``make_mesh``).

A mesh here is a 1-D line of ``p`` ranks bound one to one to ``p``
virtual devices that all live on one ``torch.device``: ``p`` virtual
ranks inside one card's memory (the GPU analog of the JAX tests'
8-device virtual CPU mesh), or on the CPU for the tests. Each rank's
shard is its own allocation; one kernel launch covers all ``p`` ranks
(``ops/ring.py``, ``ops/ici.py``). Multi-axis meshes are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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
