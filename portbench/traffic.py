"""The one general traffic driver. A traffic mix is a data file
(`traffic/<name>.json`) whose `mode` picks one of three loops and whose
other keys are its parameters:

  "batches"  closed loop, one caller: back-to-back query batches of
             `batch` queries through `StreamingIndex.constrained_knn`.
  "updates"  closed loop, one caller: batches of `update_batch` updates,
             each deleting the oldest live point and inserting a new one
             of the configuration's distribution (`delete` then `add`);
             one batch of `query_batch` queries after every
             `queries_every`-th update batch.
  "serve"    open loop: single-query requests through
             `SearchFrontend.submit` at `rate_per_s` (Poisson).

Queries (`queries`): {"kind": "uniform_bbox"} draws them uniformly in the
configuration's query box. With "same_for_every_seed": true the window's queries (and the open loop's
arrivals) come from one fixed stream, the same for every seed, over the
seed's own data.

Every loop times all the work of the window on the host's clock and
returns what the window produced, for the comparison, with each
answer's place in the benchmark's own account of acknowledged writes.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from . import data

# arrivals: the same multiset of unit-rate gaps for every seed (drawn
# from this fixed stream), put in an order the run's seed chooses
ARRIVAL_STREAM = 0x5E7E


class Account:
    """The benchmark's account of acknowledged writes: the point of each
    global id an `add` or `bulk_load` returned, and the order of adds,
    deletes and query batches."""

    def __init__(self, dim: int):
        self.dim = dim
        self.points = np.zeros((0, dim), np.float32)
        self.events = []   # ("add", gids) | ("delete", gids)

    def added(self, gids, pts) -> None:
        gids = np.asarray(gids, np.int64)
        top = int(gids.max()) + 1 if len(gids) else 0
        if top > len(self.points):
            grown = np.zeros((max(top, 2 * len(self.points)), self.dim), np.float32)
            grown[:len(self.points)] = self.points
            self.points = grown
        self.points[gids] = pts
        self.events.append(("add", gids))

    def deleted(self, gids) -> None:
        self.events.append(("delete", np.asarray(gids, np.int64)))

    @property
    def position(self) -> int:
        """The account's length: an answer given now is due over the live
        set after exactly these events."""
        return len(self.events)

    def live_masks(self, positions):
        """Yield (position, live mask over gids) at each of the sorted
        `positions`."""
        live = np.zeros(len(self.points), bool)
        done = 0
        for pos in sorted(set(positions)):
            for kind, gids in self.events[done:pos]:
                live[gids] = kind == "add"
            done = pos
            yield pos, live


def make_queries(spec: dict, n: int, rng, lo, hi):
    kind = spec["kind"]
    if kind == "uniform_bbox":
        return data.uniform_queries(lo, hi, n, rng)
    raise ValueError(f"unknown query kind {kind!r}")


class Answers:
    """What a window produced: per answered query its vector, gids and
    distances and the account position it is due at."""

    def __init__(self):
        self.q, self.g, self.d, self.pos = [], [], [], []

    def add(self, q, g, d, pos) -> None:
        self.q.append(np.asarray(q, np.float32).reshape(-1, q.shape[-1]))
        self.g.append(np.asarray(g, np.int64).reshape(len(self.q[-1]), -1))
        self.d.append(np.asarray(d, np.float32).reshape(len(self.q[-1]), -1))
        self.pos.append(np.full(len(self.q[-1]), pos, np.int64))

    def arrays(self):
        if not self.q:
            return None
        return (np.concatenate(self.q), np.concatenate(self.g),
                np.concatenate(self.d), np.concatenate(self.pos))


def run_batches(env, seconds: float, rng) -> dict:
    """Back-to-back batches until `seconds` have passed; all the work of
    the window over all its time."""
    tr, idx, k, r = env.traffic, env.index, env.k, env.r
    ans = Answers()
    n_q = failed = batches = 0
    batch_s = []
    t0 = time.perf_counter()
    while True:
        q = make_queries(tr["queries"], tr["batch"], rng, env.lo, env.hi)
        tb = time.perf_counter()
        try:
            res = idx.constrained_knn(q, k, r)
            ans.add(q, res.gids, res.distances, env.account.position)
        except Exception as e:  # a failed batch counts, and the run goes on
            env.log(f"batch {batches} failed: {e!r}")
            failed += len(q)
        n_q += len(q)
        batches += 1
        batch_s.append(time.perf_counter() - tb)
        if time.perf_counter() - t0 >= seconds:
            break
    env.sync()
    return {"seconds": time.perf_counter() - t0, "queries": n_q,
            "attempted": n_q, "failed": failed, "batches": batches,
            "batch_s": batch_s, "answers": ans}


def update_batch(env, rng, fifo, timers=None) -> int:
    """One batch of updates: delete the oldest live points, insert as
    many new ones. Returns how many acknowledgements were missing."""
    tr, idx = env.traffic, env.index
    b = tr["update_batch"]
    victims = np.fromiter((fifo.popleft() for _ in range(b)), np.int64, b)
    new = data.points(env.config["dataset"]["generator"], b, env.dim, rng)
    t0 = time.perf_counter()
    n_del = idx.delete(victims)
    t1 = time.perf_counter()
    gids = np.asarray(idx.add(new), np.int64)
    t2 = time.perf_counter()
    env.account.deleted(victims)
    env.account.added(gids, new)
    fifo.extend(gids.tolist())
    if timers is not None:
        timers["delete_s"] += t1 - t0
        timers["add_s"] += t2 - t1
    return (b - int(n_del)) + (b - len(gids))


def query_batch(env, rng, ans=None, times=None) -> None:
    tr = env.traffic
    q = make_queries(tr["queries"], tr["query_batch"], rng, env.lo, env.hi)
    t0 = time.perf_counter()
    res = env.index.constrained_knn(q, env.k, env.r)
    if times is not None:
        times.append(time.perf_counter() - t0)
    if ans is not None:
        ans.add(q, res.gids, res.distances, env.account.position)


def query_rng(tr: dict, rng):
    """The stream a mix's queries come from: the run's, or with
    `same_for_every_seed` one fixed stream, so that every seed offers the
    same queries (over its own data). Small batches need it: the deepest
    of a few queries sets the walk's length, so a seed that chose them
    would change the work."""
    return data.rng_for(ARRIVAL_STREAM, 2) if tr["queries"].get("same_for_every_seed") else rng


def run_updates(env, seconds: float, rng) -> dict:
    """Update batches with a query batch after every `queries_every`-th,
    until `seconds` have passed (checked after every batch)."""
    tr = env.traffic
    qrng = query_rng(tr, rng)
    ans = Answers()
    timers = {"delete_s": 0.0, "add_s": 0.0}
    qtimes = []
    updates = acked = batches = missing = failed = n_q = 0
    t0 = time.perf_counter()
    while True:
        try:
            lost = update_batch(env, rng, env.fifo, timers)
            missing += lost
            acked += tr["update_batch"] - lost
        except Exception as e:
            env.log(f"update batch {batches} failed: {e!r}")
            failed += tr["update_batch"]
        updates += tr["update_batch"]
        batches += 1
        if batches % tr["queries_every"] == 0:
            try:
                query_batch(env, qrng, ans, qtimes)
            except Exception as e:
                env.log(f"query batch after update batch {batches} failed: {e!r}")
                failed += tr["query_batch"]
            n_q += tr["query_batch"]
        if time.perf_counter() - t0 >= seconds:
            break
    env.sync()
    return {"seconds": time.perf_counter() - t0, "updates": updates,
            "acked": acked, "queries": n_q, "attempted": updates + n_q, "failed": failed,
            "missing_acks": missing, "update_batches": batches,
            "query_batch_s": qtimes, **timers, "answers": ans}


def arrival_offsets(tr: dict, seconds: float, rng) -> np.ndarray:
    """Send times in [0, seconds): a fixed multiset of exponential gaps at
    `rate_per_s` (the same for every seed, so every run offers the same
    number of requests), shuffled by the run's seed and cumulated."""
    rate = float(tr["rate_per_s"])
    base = data.rng_for(ARRIVAL_STREAM, int(rate * 1000), int(seconds * 1000))
    gaps = base.exponential(1.0 / rate, size=int(seconds * rate * 1.5) + 64)
    n = int(np.searchsorted(np.cumsum(gaps), seconds))
    gaps = rng.permutation(gaps[:n])
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def open_loop(env, offsets: np.ndarray, queries: np.ndarray, wait_s: float) -> dict:
    """Send queries[i] at offsets[i] through the frontend from this
    thread; wait for every reply up to `wait_s` past the last due send.
    Latency is timed from the scheduled send time; a request that fails,
    is refused or never answers has latency +inf."""
    fe = env.frontend
    n = len(offsets)
    done = np.full(n, np.nan)
    replies = [None] * n
    errors = [None] * n
    lag = np.zeros(n)
    pending = threading.Semaphore(0)

    def callback(i):
        def on_done(fut):
            done[i] = time.perf_counter()
            exc = fut.exception()
            if exc is None:
                replies[i] = fut.result()
            else:
                errors[i] = exc
            pending.release()
        return on_done

    t0 = time.perf_counter() + 0.01
    submitted = 0
    for i in range(n):
        due = t0 + offsets[i]
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        lag[i] = time.perf_counter() - due
        try:
            fe.submit(queries[i]).add_done_callback(callback(i))
            submitted += 1
        except Exception as e:  # refused: counts as failed
            errors[i] = e
            done[i] = time.perf_counter()
    deadline = t0 + (offsets[-1] if n else 0.0) + wait_s
    for _ in range(submitted):
        if not pending.acquire(timeout=max(0.0, deadline - time.perf_counter())):
            break
    t_end = time.perf_counter()
    lat = (done - (t0 + offsets)) * 1e3
    ok = np.array([replies[i] is not None for i in range(n)], bool)
    lat = np.where(ok, lat, np.inf)
    return {"t0": t0, "t_end": t_end, "latency_ms": lat, "replies": replies,
            "ok": ok, "errors": [repr(e) for e in errors if e is not None][:5],
            "send_lag_ms": lag * 1e3}


def run_serve(env, seconds: float, rng) -> dict:
    tr = env.traffic
    rng = query_rng(tr, rng)   # the arrivals too
    offsets = arrival_offsets(tr, seconds, rng)
    q = make_queries(tr["queries"], len(offsets), rng, env.lo, env.hi)
    out = open_loop(env, offsets, q, env.wait_s)
    ans = Answers()
    ok = out["ok"]
    if ok.any():
        rows = np.nonzero(ok)[0]
        ans.add(q[rows], np.stack([out["replies"][i].gids for i in rows]),
                np.stack([out["replies"][i].distances for i in rows]),
                env.account.position)
    env.sync()
    n = len(offsets)
    return {"seconds": float(seconds), "requests": n, "attempted": n,
            "failed": int(n - ok.sum()), "latency_ms": out["latency_ms"],
            "send_lag_ms": out["send_lag_ms"], "errors": out["errors"],
            "wait_s": env.wait_s,
            "drain_s": out["t_end"] - (out["t0"] + seconds), "answers": ans}


WINDOWS = {"batches": run_batches, "updates": run_updates, "serve": run_serve}

