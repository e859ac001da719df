"""QuerySpec: the one description of a read that every engine consumes."""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """What a constrained-KNN read wants, independent of which index
    (static tree, streaming snapshot) answers it.

    k             number of neighbors per query
    radius        range constraint r: scalar, or a (Q,) per-query array;
                  np.inf degenerates to plain KNN (the paper's Liu et
                  al. reduction)
    dtype         torch dtype for centers/points/distances
    return_visits when True the engine also reports per-query traversal
                  node-visit counts (the paper's Fig 6 accounting)
    """

    k: int
    radius: Any = np.inf
    dtype: torch.dtype = torch.float32
    return_visits: bool = False

    def __post_init__(self) -> None:
        if self.k < 1:  # raise, not assert: must survive python -O
            raise ValueError(f"QuerySpec.k must be >= 1, got {self.k}")
