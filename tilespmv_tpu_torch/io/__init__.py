from .mmio import CSRMatrix, csr_from_coo, load_mtx, save_mtx

__all__ = ["CSRMatrix", "csr_from_coo", "load_mtx", "save_mtx"]
