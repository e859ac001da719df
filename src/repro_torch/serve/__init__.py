"""Serving tier of the port (the reference's `serve/`).

  * `retrieval` — the kNN-LM `Datastore`: a mutable key set on the
    streaming index with a values arena (freelist, reclaim on the gid
    remap epoch), and `knn_interpolate`;
  * `frontend` — `SearchFrontend`: continuous batching into pow2 batch
    classes with admission control (`block` / `reject` /
    `shed_oldest`), deadlines, graceful drain, and `RetryingClient`.

The reference's `serve/engine.py` (the LM generation engine) waits for
the port of the model stack.
"""
