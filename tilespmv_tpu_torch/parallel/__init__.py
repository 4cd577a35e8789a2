"""The multi-device layer: the 1-D row partition (`DistributedSpMV`,
x by allgather, replicated or halo exchange) and the 2-D block partition
(`DistributedSpMV2D`) over a mesh of torch devices (`make_mesh`,
`make_mesh2d`; a device may repeat, as virtual shards), driven by one
process or, after `initialize_multihost`, by one process per card or
host over a torch.distributed process group."""
from .distributed import DistributedSpMV
from .distributed2d import DistributedSpMV2D
from .mesh import (COL_AXIS, ROW_AXIS, Mesh, initialize_multihost, make_mesh,
                   make_mesh2d)

__all__ = ["DistributedSpMV", "DistributedSpMV2D", "Mesh", "make_mesh",
           "make_mesh2d", "initialize_multihost", "ROW_AXIS", "COL_AXIS"]
