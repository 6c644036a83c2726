from .mesh import Mesh, MeshComm, P, make_mesh

__all__ = ["Mesh", "MeshComm", "P", "make_mesh"]
