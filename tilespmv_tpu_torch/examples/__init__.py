"""Iterative solvers with TileSpMV as the operator: conjugate gradient
(`cg`) and PageRank (`pagerank`)."""
