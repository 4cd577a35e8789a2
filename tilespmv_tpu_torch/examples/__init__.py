"""Iterative solvers with TileSpMV as the operator: conjugate gradient
(`cg`) and PageRank (`pagerank`); and the multi-device walkthrough
(`distributed_run`)."""
