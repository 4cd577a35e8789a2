"""Scripts of the port, run as modules from the repository root, e.g.
`python -m tilespmv_tpu_torch.scripts.microbench_gather`."""
