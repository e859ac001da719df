"""Ball*-tree construction and constrained-NN search on PyTorch.

`build.build` is the level-synchronous builder (the reference's
`build_jax`), `search` the batched traversal (the reference's
`search_jax`). The reference's host builder/searcher, brute oracles and
distributed index wait for later slices; the tests use the reference
package's copies as oracles.
"""
from .types import Tree, TreeSpec  # noqa: F401
from . import search  # noqa: F401
from .build import build  # noqa: F401  (the function shadows the module)
