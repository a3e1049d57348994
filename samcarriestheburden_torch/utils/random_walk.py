"""Shim for the reference's ``utils.random_walk``.

The pyamg sparse-multigrid plumbing (sparseMultiGrid, sparse_rows/cols) has no
counterpart: the solver runs as conjugate gradients on the device; see
``ops/random_walk.py``."""
from samcarriestheburden_torch.ops.random_walk import (  # noqa: F401
    apply_laplacian, edge_weights, random_walk, random_walk_probs)
