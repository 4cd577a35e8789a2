"""plan_s: host-clock seconds of `TileSpMV(csr, dtype=...)`, synchronized
(conversion, planning and upload: the program's part of setup_s)."""


def read(rec):
    return rec.plan_s
