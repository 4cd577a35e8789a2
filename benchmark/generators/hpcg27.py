"""HPCG's problem: the 27-point stencil of GenerateProblem_ref.cpp.

Row (ix, iy, iz) of an nx x ny x nz grid, numbered ix + nx*iy +
nx*ny*iz, holds one entry for each of its 27 neighbours (itself
included) that lies inside the grid, in HPCG's loop order (sz, sy, sx
from -1 to 1), which is ascending column order. HPCG sets 26 on the
diagonal and -1 elsewhere; here every value is drawn from the seed as
(k + 1) / 4, k uniform in 0..9, so that no kernel can lean on constant
values (the configuration lists this under `assumed`).
"""
import torch


def generate(cfg: dict, gen: torch.Generator, device, dtype: torch.dtype):
    """(m, n, indptr int64, indices int32, data `dtype`) on `device`."""
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    m = nx * ny * nz
    i = torch.arange(m, device=device)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    d = torch.arange(-1, 2, device=device)
    dz, dy, dx = torch.meshgrid(d, d, d, indexing="ij")
    dz, dy, dx = dz.reshape(1, 27), dy.reshape(1, 27), dx.reshape(1, 27)
    jx, jy, jz = ix[:, None] + dx, iy[:, None] + dy, iz[:, None] + dz
    inside = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
              & (jz >= 0) & (jz < nz))
    cols = (jx + nx * jy + nx * ny * jz)[inside]
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(inside.sum(1), 0)
    data = ((torch.randint(0, 10, (cols.numel(),), generator=gen,
                           device=device) + 1).to(torch.float64) / 4
            ).to(dtype)
    return m, m, indptr, cols.to(torch.int32), data
