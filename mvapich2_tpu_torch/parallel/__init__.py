from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
