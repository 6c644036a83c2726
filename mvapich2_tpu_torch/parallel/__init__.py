from .mesh import Mesh, MeshComm, make_mesh

__all__ = ["Mesh", "MeshComm", "make_mesh"]
