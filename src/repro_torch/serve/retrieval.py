"""Retrieval-augmented serving: the paper's constrained-NN search as a
first-class feature of the LM stack (kNN-LM style).

A datastore maps hidden states (keys) -> next tokens (values). At decode
time the engine queries the index for the K nearest stored states
WITHIN RADIUS r of the current hidden state — the paper's
range-constrained KNN (§4.3) is exactly the right primitive here: far-
away neighbors are noise, so the range constraint both prunes the search
(fewer nodes visited, Table 2) and gates interpolation quality.

p(y) = (1 - lam_eff) * p_LM(y) + lam_eff * p_kNN(y),
with lam_eff = lam * [any neighbor within r] and p_kNN a distance-
softmax over retrieved values.

The datastore is *mutable* (a port of the reference's
`serve/retrieval.py`): it is backed by the streaming LSM index
(`repro_torch.index`), so the kNN-LM memory can grow during decode (`add`
newly generated (state, token) pairs) and forget (`delete` by the ids
`add` returned) — online memory for long-running serving, with results
always exact over the current live key set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import obs
from ..core import TreeSpec
from ..index import StreamingConfig, StreamingIndex
from ..query import QuerySpec


@dataclasses.dataclass
class Datastore:
    index: StreamingIndex
    # values arena: a dense amortized-doubling row buffer plus a
    # gid -> row indirection. The old layout burned one slot per
    # EVER-ASSIGNED gid, so a long-running store whose points churn
    # (add + delete) leaked value slots forever. Rows are recycled
    # through a freelist the moment a gid is evicted, and the arena is
    # compacted (rows rewritten dense, indirection rebuilt) when the
    # index's gid-remap epoch advances past the last one we saw AND the
    # hole fraction exceeds `_RECLAIM_HOLES` — merges are exactly when
    # the index itself purges tombstones, so the arena shrinks on the
    # same cadence as the key storage.
    _values: np.ndarray                  # (rows,) i32 dense row buffer
    _row_of: dict                        # live gid -> row
    _free: list                          # recycled rows
    _next_row: int = 0                   # high-water row cursor
    _seen_epoch: int = 0

    _RECLAIM_HOLES = 0.5

    @property
    def values(self) -> np.ndarray:
        """(next_gid,) int32 materialized gid-indexed view (0 where the
        gid is dead) — introspection/compat only; storage is the dense
        row arena behind the gid indirection."""
        out = np.zeros(int(self.index.log.next_gid), np.int32)
        for g, row in self._row_of.items():
            out[g] = self._values[row]
        return out

    @staticmethod
    def from_pairs(
        keys: np.ndarray,
        values: np.ndarray,
        leaf_size: int = 64,
        backend: str = "torch",
        spec: Optional[TreeSpec] = None,
        delta_capacity: int = 4096,
        device: str = "cuda",
    ) -> "Datastore":
        """Bulk-load an initial key set. `spec` overrides the default
        ballstar spec entirely (splitter/threshold/alpha tunable by the
        caller); `leaf_size` is a convenience for the default spec.
        `backend` picks the tree builder ("torch" on `device`, or
        "host"); the index's tensors live on `device`."""
        keys = np.asarray(keys, np.float32)
        vals = np.ascontiguousarray(values, np.int32).reshape(-1)
        if len(vals) != len(keys):
            raise ValueError(
                f"from_pairs: {len(keys)} keys but {len(vals)} values"
            )
        spec = spec or TreeSpec.ballstar(leaf_size=leaf_size)
        index = StreamingIndex(
            StreamingConfig(
                dim=keys.shape[1],
                delta_capacity=delta_capacity,
                spec=spec,
                backend=backend,
                device=device,
            )
        )
        gids = index.bulk_load(keys)
        store = Datastore(index=index, _values=np.zeros(0, np.int32),
                          _row_of={}, _free=[])
        store._seen_epoch = index.log.epoch
        store._bind(gids, vals)
        return store

    @property
    def n_keys(self) -> int:
        return self.index.n_live

    @property
    def arena_rows(self) -> int:
        """Current dense values-arena length (introspection/tests)."""
        return len(self._values)

    def _bind(self, gids: np.ndarray, vals: np.ndarray) -> None:
        """Assign each gid a row (freelist first, then the high-water
        cursor, doubling the dense buffer as needed) and store its
        value there."""
        rows = np.empty(len(gids), np.int64)
        take = min(len(self._free), len(gids))
        for i in range(take):
            rows[i] = self._free.pop()
        fresh = len(gids) - take
        if fresh:
            need = self._next_row + fresh
            if need > len(self._values):
                buf = np.zeros(max(need, 2 * len(self._values), 16), np.int32)
                buf[: self._next_row] = self._values[: self._next_row]
                self._values = buf
            rows[take:] = np.arange(self._next_row, need)
            self._next_row = need
        self._values[rows] = vals
        self._row_of.update(zip(map(int, gids), map(int, rows)))

    def _maybe_reclaim(self) -> None:
        """Compact the values arena after the index remapped gids
        (merges purge tombstones — the moment value holes are stale
        garbage, not transient churn) once holes dominate."""
        epoch = self.index.log.epoch
        if epoch <= self._seen_epoch:
            return
        self._seen_epoch = epoch
        used = self._next_row
        holes = used - len(self._row_of)
        if used == 0 or holes <= self._RECLAIM_HOLES * used:
            return
        gids = np.fromiter(self._row_of.keys(), np.int64, len(self._row_of))
        old_rows = np.fromiter(
            self._row_of.values(), np.int64, len(self._row_of)
        )
        dense = self._values[old_rows]
        buf = np.zeros(max(len(dense), 16), np.int32)
        buf[: len(dense)] = dense
        self._values = buf
        self._row_of = dict(zip(map(int, gids), range(len(gids))))
        self._free = []
        self._next_row = len(gids)
        if obs.REGISTRY.enabled:
            obs.REGISTRY.counter("serve.values_reclaims").inc()
            obs.REGISTRY.counter("serve.values_rows_freed").inc(int(holes))

    def add(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Append (state, token) pairs to the live memory; returns the
        global ids (pass to `delete` to evict)."""
        vals = np.asarray(values, np.int32).reshape(-1)
        keys = np.asarray(keys, np.float32).reshape(-1, self.index.config.dim)
        if len(vals) != len(keys):  # validate BEFORE mutating the index
            raise ValueError(
                f"add: {len(keys)} keys but {len(vals)} values"
            )
        gids = self.index.add(keys)
        self._bind(gids, vals)
        self._maybe_reclaim()
        return gids

    def delete(self, gids: np.ndarray) -> int:
        """Evict stored states by id (tombstoned now, purged at merge).
        The values rows of evicted gids return to the freelist at once."""
        gids = np.atleast_1d(np.asarray(gids, np.int64))
        n = self.index.delete(gids)
        for g in gids:
            row = self._row_of.pop(int(g), None)
            if row is not None:
                self._free.append(row)
        self._maybe_reclaim()
        return n

    def search(self, queries: np.ndarray, spec: QuerySpec):
        """Constrained NN over the live key set — a thin adapter over
        the unified query engine (one snapshot, one engine call)."""
        from ..query import engine as qengine

        if obs.REGISTRY.enabled:
            obs.REGISTRY.counter("serve.queries").inc(
                int(np.asarray(queries).reshape(-1, self.index.config.dim).shape[0])
            )
        with obs.span("serve.search"):
            return qengine.execute(self.index.snapshot(), queries, spec)

    def lookup(self, queries: np.ndarray, k: int, r: float):
        """Constrained NN over the live datastore. Returns (token values
        (Q, k), distances (Q, k), valid mask)."""
        with obs.span("serve.lookup"):
            res = self.search(queries, QuerySpec(k=k, radius=r))
        idx = np.asarray(res.gids, np.int64)
        dist = np.asarray(res.distances, np.float32)
        # a gid without a bound row is a point whose token is not
        # published yet (a concurrent add between index publish and the
        # values bind): treat it as a transient miss, never as another
        # state's token
        row_of = self._row_of
        flat = idx.reshape(-1)
        rows = np.fromiter(
            (row_of.get(int(g), -1) for g in flat), np.int64, len(flat)
        ).reshape(idx.shape)
        valid = rows >= 0
        if len(self._values) == 0:  # bootstrap before first add
            return np.zeros(idx.shape, np.int32), dist, valid
        vals = self._values[np.clip(rows, 0, len(self._values) - 1)]
        vals = np.where(valid, vals, 0)
        return vals, dist, valid


def knn_interpolate(
    lm_probs: np.ndarray,   # (B, V)
    neigh_vals: np.ndarray,  # (B, k) int32
    neigh_dist: np.ndarray,  # (B, k)
    valid: np.ndarray,       # (B, k) bool
    lam: float = 0.25,
    temp: float = 1.0,
) -> np.ndarray:
    """Mix LM and kNN distributions (kNN-LM, Khandelwal et al. form)."""
    B, V = lm_probs.shape
    out = lm_probs.copy()
    for b in range(B):
        m = valid[b]
        if not m.any():
            continue  # no neighbor within range: pure LM
        w = np.exp(-neigh_dist[b][m] / temp)
        w = w / w.sum()
        knn = np.zeros(V)
        np.add.at(knn, neigh_vals[b][m], w)
        out[b] = (1 - lam) * lm_probs[b] + lam * knn
    return out
