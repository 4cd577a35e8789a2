"""The multi-device layer: the 1-D row partition (`DistributedSpMV`,
x by allgather, replicated or halo exchange) and the 2-D block partition
(`DistributedSpMV2D`) over a mesh of torch devices driven by one
process (`make_mesh`, `make_mesh2d`; a device may repeat, as virtual
shards). Multi-host runs (the reference's `initialize_multihost`) are
not ported."""
from .distributed import DistributedSpMV
from .distributed2d import DistributedSpMV2D
from .mesh import COL_AXIS, ROW_AXIS, Mesh, make_mesh, make_mesh2d

__all__ = ["DistributedSpMV", "DistributedSpMV2D", "Mesh", "make_mesh",
           "make_mesh2d", "ROW_AXIS", "COL_AXIS"]
