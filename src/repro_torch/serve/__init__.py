"""Serving tier of the port (the reference's `serve/`).

  * `retrieval` — the kNN-LM `Datastore`: a mutable key set on the
    streaming index with a values arena (freelist, reclaim on the gid
    remap epoch), and `knn_interpolate`;
  * `frontend` — `SearchFrontend`: continuous batching into pow2 batch
    classes with admission control (`block` / `reject` /
    `shed_oldest`), deadlines, graceful drain, and `RetryingClient`;
  * `engine` — the LM generation `Engine`: prefill and batched decode
    over the dense models of `repro_torch.models`, greedy or sampled
    with one `torch.Generator` a request (the launcher
    `repro_torch.launch.serve` drives it, with retrieval over the
    Datastore).
"""
