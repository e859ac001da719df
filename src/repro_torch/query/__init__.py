"""Unified query engine: the one read path over every index form.

    plan:     group a snapshot's segments into pow2 *shape classes*
              (`shapes.py`)
    traverse: one stacked dispatch per class
              (`core/search.constrained_knn_stacked_fused`); the delta
              arena joins as a degenerate class (the `topk_l2` kernel)
    merge:    one sorted-merge primitive (`merge.py`) folds the
              per-part k-bests — no argsort of the concatenation

Note: `engine` and `shapes` are imported lazily (PEP 562) — they pull in
core and index, while `merge`/`spec` stay dependency-light so lower
layers can import them without cycles.
"""
from . import merge  # noqa: F401  (dependency-free: safe to load eagerly)
from .spec import QuerySpec  # noqa: F401

__all__ = ["merge", "shapes", "engine", "QuerySpec"]


def __getattr__(name):
    if name in ("engine", "shapes"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
