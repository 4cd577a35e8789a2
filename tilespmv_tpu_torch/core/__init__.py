from .convert import tile_create
from .tile_matrix import TileMatrix

__all__ = ["tile_create", "TileMatrix"]
