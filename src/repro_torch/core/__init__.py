"""Ball*-tree construction and constrained-NN search on PyTorch.

Two builders behind `build(..., backend=...)`, both returning the shared
`Tree` layout:

  * "torch" (default) — `core/build.py`, the level-synchronous builder on
    the device (the reference's `build_jax`);
  * "host" — `build_host`, the paper-faithful recursive numpy builder
    (Algorithm 1), a copy of the reference's, giving its tree bitwise.

`search` is the batched device traversal (the reference's `search_jax`);
`search_host` the paper's searches on the host with their node counts,
`brute` the exact oracles, `pca` the host power iteration and the exact
eigenvector; `distributed` the sharded static index and the distributed
brute baseline.
"""
from .types import Tree, TreeSpec  # noqa: F401
from . import brute, build_host, search, search_host  # noqa: F401
from . import distributed  # noqa: F401
from .build import build as _build_torch
from .pca import first_component_exact, first_component_host  # noqa: F401


def build(points, spec=None, backend: str = "torch", device="cuda"):
    """Build a tree with the requested backend: "torch" (on `device`) or
    "host" (numpy; `device` unused)."""
    if backend == "torch":
        return _build_torch(points, spec, device=device)
    if backend == "host":
        return build_host.build(points, spec)
    raise ValueError(f"unknown backend {backend!r}")
